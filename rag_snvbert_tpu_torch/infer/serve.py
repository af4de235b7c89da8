"""In-process imputation service: the model and reference panel are loaded
once, and requests stream through the resident imputer.

Port of rag_snvbert_tpu/infer/serve.py:33-78 (``create`` and
``handle_target``).  The file-based ``handle``, the JSON-lines loop and
the cross-request ``BatchingImputationService`` need VCF reading and are
not ported yet.
"""

from __future__ import annotations

import dataclasses

from ..io.freq import FreqTable
from ..io.vcf import VCFData
from .imputer import ImputationResult, Imputer


@dataclasses.dataclass
class ImputationService:
    """Resident imputation state."""

    imputer: Imputer
    ref_vcf: VCFData

    @classmethod
    def create(cls, model, ref_vcf: VCFData, freq: FreqTable,
               device=None, **imputer_kw) -> "ImputationService":
        """``device=None`` serves on the card (raises without one);
        ``imputer_kw`` go to ``Imputer`` (``rag_mode="token"`` serves a
        V17 ``BERTWithRAG`` model)."""
        imp = Imputer(model, ref_vcf, freq, device=device, **imputer_kw)
        return cls(imputer=imp, ref_vcf=ref_vcf)

    def handle_target(self, target: VCFData,
                      rounds: int = 1) -> ImputationResult:
        """Impute one parsed target (``rounds > 1``: progressive)."""
        if rounds > 1:
            return self.imputer.impute_progressive(target, rounds=rounds)
        return self.imputer.impute(target)
