"""Static token vocabulary for haplotype sequences.

The reference builds its vocabulary dynamically with a Counter
(src/dataset/vocab.py:122-151), but the result is fully deterministic:
5 special tokens, then phased alleles {0, 1} in insertion order, then
population labels.  We make that table explicit and static — token ids are
compile-time constants, which is what XLA wants.

Reference parity: src/dataset/vocab.py:84-189 (Vocab special indices,
WordVocab.to_seq padding semantics).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

# Special token ids (src/dataset/vocab.py:91-95).
PAD = 0
UNK = 1
SOS = 2
EOS = 3
MASK = 4

# Alleles follow the specials in Counter insertion order ({0, 1}):
# allele a -> ALLELE_OFFSET + a  (src/dataset/vocab.py:140-151).
ALLELE_OFFSET = 5
N_ALLELES = 2

# Population label tokens start here.
POP_OFFSET = ALLELE_OFFSET + N_ALLELES  # 7

# Fixed sequence geometry (src/dataset/dataset.py:26-27).
MAX_SEQ_LEN = 1030
INFER_WINDOW_LEN = 1020


@dataclasses.dataclass(frozen=True)
class Vocab:
    """Haplotype token vocabulary: specials + alleles + population labels.

    ``pops`` is the ordered list of distinct population labels; their token
    ids are ``POP_OFFSET + index``.
    """

    pops: tuple[str, ...] = ()

    @property
    def size(self) -> int:
        return POP_OFFSET + len(self.pops)

    # Convenience aliases mirroring the reference attribute names.
    pad_index = PAD
    unk_index = UNK
    sos_index = SOS
    eos_index = EOS
    mask_index = MASK

    def allele_token(self, allele: int) -> int:
        return ALLELE_OFFSET + int(allele)

    def pop_token(self, pop: str) -> int:
        return POP_OFFSET + self.pops.index(pop)

    def to_seq(self, alleles: np.ndarray, seq_len: int = MAX_SEQ_LEN) -> np.ndarray:
        """Tokenize one window of alleles: [SOS] + tokens + [EOS] + padding.

        Mirrors WordVocab.to_seq(with_sos=True) (src/dataset/vocab.py:153-170):
        sequences longer than ``seq_len`` are truncated *after* SOS/EOS
        insertion, shorter ones are padded with PAD.
        """
        n = int(alleles.shape[-1])
        out = np.full(seq_len, PAD, dtype=np.int32)
        out[0] = SOS
        body = np.minimum(n, seq_len - 1)
        out[1 : 1 + body] = ALLELE_OFFSET + alleles[:body].astype(np.int32)
        if n + 1 < seq_len:
            out[n + 1] = EOS
        return out

    def save_json(self, path: str) -> None:
        stoi = {"<pad>": PAD, "<unk>": UNK, "<sos>": SOS, "<eos>": EOS, "<mask>": MASK,
                "0": ALLELE_OFFSET, "1": ALLELE_OFFSET + 1}
        for i, p in enumerate(self.pops):
            stoi[p] = POP_OFFSET + i
        with open(path, "w", encoding="utf-8") as f:
            json.dump(stoi, f, indent=4)

    @classmethod
    def from_panel_pops(cls, pops: list[str]) -> "Vocab":
        """Build from a panel's population column, keeping first-seen order
        (Counter insertion order in the reference)."""
        seen: dict[str, None] = {}
        for p in pops:
            seen.setdefault(p, None)
        return cls(pops=tuple(seen.keys()))
