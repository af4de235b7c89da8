"""Vectorized tokenization and fixed-shape padding.

Pure numpy functions (host side); copy of rag_snvbert_tpu/data/tokenize.py.
All outputs have the fixed shape ``[*, MAX_SEQ_LEN]``.

Reference parity:
  - sequence_padding (src/dataset/utils.py:120-132): prepend one pad slot
    for [SOS], pad tail to MAX_SEQ_LEN.
  - tokenize (src/dataset/dataset.py:585-625): vocab.to_seq + mask overwrite.
  - position_normalize (src/dataset/utils.py:109-118).
"""

from __future__ import annotations

import numpy as np

from ..io.vocab import ALLELE_OFFSET, EOS, MASK, MAX_SEQ_LEN, PAD, SOS


def sequence_padding(seq: np.ndarray, seq_len: int = MAX_SEQ_LEN) -> np.ndarray:
    """Pad a per-site array to ``seq_len`` with one leading slot for [SOS].

    Works on the last axis; supports any leading batch dims.
    Mirrors VCFProcessingModule.sequence_padding (src/dataset/utils.py:120-132).
    """
    seq = np.asarray(seq)
    n = seq.shape[-1]
    assert n <= seq_len - 1, f"window length {n} exceeds {seq_len - 1}"
    out = np.zeros(seq.shape[:-1] + (seq_len,), dtype=seq.dtype)
    out[..., 1 : 1 + n] = seq
    return out


def position_normalize(pos: np.ndarray) -> np.ndarray:
    """0-1 normalize genomic positions within a window
    (src/dataset/utils.py:109-118)."""
    pos = np.asarray(pos, dtype=np.float64)
    lo, hi = pos.min(), pos.max()
    rng = hi - lo
    if rng == 0:
        return np.zeros_like(pos, dtype=np.float32)
    return ((pos - lo) / rng).astype(np.float32)


def tokenize(alleles: np.ndarray, mask: np.ndarray | None = None,
             seq_len: int = MAX_SEQ_LEN) -> np.ndarray:
    """Tokenize 0/1 allele arrays to [SOS] a... [EOS] pad..., applying a mask.

    Args:
      alleles: int array ``[..., n_sites]`` of phased alleles in {0, 1}.
      mask: optional int/bool array ``[seq_len]`` or broadcastable to the
        output shape; positions with mask==1 become the [MASK] token.
        The mask is in *padded* coordinates (slot 0 = SOS, slot i = site i-1),
        matching the reference where the raw mask is padded with
        sequence_padding before use (src/dataset/dataset.py:529-536).

    Returns int32 ``[..., seq_len]`` token ids.
    """
    alleles = np.asarray(alleles)
    n = alleles.shape[-1]
    batch_shape = alleles.shape[:-1]
    out = np.full(batch_shape + (seq_len,), PAD, dtype=np.int32)
    out[..., 0] = SOS
    out[..., 1 : 1 + n] = ALLELE_OFFSET + alleles.astype(np.int32)
    if n + 1 < seq_len:
        out[..., n + 1] = EOS
    if mask is not None:
        mask = np.asarray(mask).astype(bool)
        out = np.where(mask, np.int32(MASK), out)
    return out


def genotype_label(h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
    """4-class genotype label (h1<<1)+h2 (src/dataset/dataset.py:527)."""
    return (h1.astype(np.int32) << 1) + h2.astype(np.int32)
