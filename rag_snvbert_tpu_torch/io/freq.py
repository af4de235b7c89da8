"""Frequency matrix: per-site genotype frequencies and allele frequencies,
global and per-population.

Layout matches the reference's Freq.npy (prepare_data_v4_0411.py:116-235):
``freq[layer, pop, site]`` float32 with layers REF=0, HET=1, HOM=2, AF=3 and
pop index ``n_pops`` = Global (the reference hardcodes GLOBAL=5 for its 5
populations, src/dataset/dataset.py:29-34; we derive it from the panel).

The reference builds this from 4 pre-computed CSVs; here it is computed
directly from the phased genotype matrix — one pass of vectorized numpy.
"""

from __future__ import annotations

import numpy as np

REF = 0
HET = 1
HOM = 2
AF = 3


def build_freq_matrix(gt: np.ndarray, pop_class: np.ndarray,
                      n_pops: int) -> np.ndarray:
    """Compute freq[4, n_pops+1, n_sites] from phased genotypes.

    Args:
      gt: [n_sites, n_samples, 2] 0/1 phased genotypes.
      pop_class: [n_samples] int population class per sample.
      n_pops: number of populations; index n_pops is the global pool.
    """
    n_sites, n_samples, _ = gt.shape
    dosage = gt.sum(axis=2)  # [V, S] in {0, 1, 2}
    out = np.zeros((4, n_pops + 1, n_sites), dtype=np.float32)

    def fill(pop_idx, cols):
        n = max(len(cols), 1)
        d = dosage[:, cols]
        out[REF, pop_idx] = (d == 0).sum(axis=1) / n
        out[HET, pop_idx] = (d == 1).sum(axis=1) / n
        out[HOM, pop_idx] = (d == 2).sum(axis=1) / n
        out[AF, pop_idx] = d.sum(axis=1) / (2 * n)

    for p in range(n_pops):
        fill(p, np.flatnonzero(pop_class == p))
    fill(n_pops, np.arange(n_samples))
    return out


class FreqTable:
    """Freq matrix + site-position lookup.

    Wraps ``freq[4, P+1, V]`` with a pos -> site-index map so per-window
    feature assembly is one fancy-index (the reference's pos_to_idx pickle,
    prepare_data_v4_0411.py:170-235).
    """

    def __init__(self, freq: np.ndarray, pos: np.ndarray):
        assert freq.shape[0] == 4
        self.freq = np.asarray(freq, np.float32)
        self.pos = np.asarray(pos, np.int64)
        self._pos_to_idx = {int(p): i for i, p in enumerate(self.pos)}

    @property
    def n_pops(self) -> int:
        return self.freq.shape[1] - 1

    @property
    def global_idx(self) -> int:
        return self.freq.shape[1] - 1

    def site_indices(self, positions: np.ndarray) -> np.ndarray:
        """Map genomic positions to freq columns (missing -> -1)."""
        return np.asarray([self._pos_to_idx.get(int(p), -1)
                           for p in positions], np.int64)

    def lookup(self, layer: int, pop: int, positions: np.ndarray,
               default: float = 0.0) -> np.ndarray:
        idx = self.site_indices(positions)
        vals = np.where(idx >= 0, self.freq[layer, pop, np.maximum(idx, 0)],
                        default)
        return vals.astype(np.float32)

    def window_features(self, positions: np.ndarray,
                        pop: int) -> dict[str, np.ndarray]:
        """All six per-site feature rows for a window (af uses the global
        pool; af_p/ref/het/hom the sample's population —
        src/dataset/dataset.py:552-580)."""
        g = self.global_idx
        return {
            "af": self.lookup(AF, g, positions),
            "af_p": self.lookup(AF, pop, positions),
            "ref": self.lookup(REF, pop, positions),
            "het": self.lookup(HET, pop, positions),
            "hom": self.lookup(HOM, pop, positions),
        }

    def save(self, path: str) -> None:
        np.savez(path, freq=self.freq, pos=self.pos)

    @classmethod
    def load(cls, path: str) -> "FreqTable":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return cls(z["freq"], z["pos"])

    @classmethod
    def load_reference_npy(cls, freq_path: str, pos: np.ndarray) -> "FreqTable":
        """Load a reference-format Freq.npy (caller supplies the positions
        the columns correspond to, i.e. the pos_to_idx ordering)."""
        return cls(np.load(freq_path), pos)
