"""In-memory genotype matrix of a VCF.

Copy of the ``VCFData`` dataclass of rag_snvbert_tpu/io/vcf.py.  Reading
and writing VCF files is not part of this package yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VCFData:
    """In-memory biallelic phased genotype matrix + site metadata."""

    gt: np.ndarray       # [n_variants, n_samples, 2] int8, binarized 0/1
    pos: np.ndarray      # [n_variants] int64
    chrom: np.ndarray    # [n_variants] object (str)
    ref: np.ndarray      # [n_variants] object (str)
    alt: np.ndarray      # [n_variants] object (str)
    ids: np.ndarray      # [n_variants] object (str)
    samples: list[str]

    @property
    def n_variants(self) -> int:
        return self.gt.shape[0]

    @property
    def n_samples(self) -> int:
        return self.gt.shape[1]
