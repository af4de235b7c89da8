"""Classification heads and the foundation-model wrapper.

Port of rag_snvbert_tpu/models/heads.py.  The heads' Dense layers carry no
dtype in the JAX package (heads.py:37-43), so they compute in the
promotion of a bf16 input with float32 parameters: float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .bert import BERT
from .layers import Dense, LayerNorm, gelu


class EnhancedHaplotypeClassifier(nn.Module):
    """AF-aware per-site 2-class head; returns logits."""

    def __init__(self, dims: int, vocab_size: int = 2):
        super().__init__()
        self.Dense_0 = Dense(dims + 2, 4 * dims)
        self.Dense_1 = Dense(4 * dims, dims)
        self.LayerNorm_0 = LayerNorm(dims)
        self.Dense_2 = Dense(dims, 4 * dims)
        self.Dense_3 = Dense(4 * dims, vocab_size)

    def forward(self, x: torch.Tensor, global_af: torch.Tensor,
                pop_af: torch.Tensor) -> torch.Tensor:
        af_feat = torch.stack([global_af, pop_af], dim=-1).to(x.dtype)
        fused = self.Dense_0(torch.cat([x, af_feat], dim=-1))
        fused = self.LayerNorm_0(self.Dense_1(gelu(fused)))
        return self.Dense_3(gelu(self.Dense_2(fused)))


class GenotypeClassifier(nn.Module):
    """4-class genotype head over ``[p(h1) | p(h2) | ref | het | hom]``."""

    def __init__(self, augment_factor: int = 2, vocab_size: int = 4):
        super().__init__()
        hidden = 4 ** augment_factor
        self.Dense_0 = Dense(7, hidden)
        self.LayerNorm_0 = LayerNorm(hidden)
        self.Dense_1 = Dense(hidden, hidden)
        self.LayerNorm_1 = LayerNorm(hidden)
        self.Dense_2 = Dense(hidden, hidden)
        self.Dense_3 = Dense(hidden, vocab_size)

    def forward(self, hap_1_probs, hap_2_probs, ref, het, hom):
        dt = hap_1_probs.dtype
        feats = torch.cat([hap_1_probs, hap_2_probs, ref[..., None].to(dt),
                           het[..., None].to(dt), hom[..., None].to(dt)],
                          dim=-1)
        h = self.LayerNorm_0(F.leaky_relu(self.Dense_0(feats), 0.01))
        f = self.LayerNorm_1(F.leaky_relu(self.Dense_1(h), 0.1))
        f = F.leaky_relu(self.Dense_2(f), 0.1)
        return self.Dense_3(f)


class BERTFoundationModel(nn.Module):
    """Encoder + dual haplotype heads + genotype head.

    Returns ``[hap_1, hap_2, gt, h1_origin, h2_origin, h1_after,
    h2_after]``; hap/gt are logits, or probabilities under
    ``compat_double_softmax``."""

    def __init__(self, bert: BERT, compat_double_softmax: bool = False):
        super().__init__()
        self.bert = bert
        self.hap_classifier = EnhancedHaplotypeClassifier(bert.dims)
        self.gt_classifier = GenotypeClassifier()
        self.compat_double_softmax = compat_double_softmax

    def forward(self, x: dict) -> list[torch.Tensor]:
        h1_after, h2_after, h1_before, h2_before = self.bert(x)
        hap_1 = self.hap_classifier(h1_after, x["af"], x["af_p"])
        hap_2 = self.hap_classifier(h2_after, x["af"], x["af_p"])
        p1 = torch.softmax(hap_1, dim=-1)
        p2 = torch.softmax(hap_2, dim=-1)
        gt = self.gt_classifier(p1, p2, x["ref"], x["het"], x["hom"])
        if self.compat_double_softmax:
            hap_1, hap_2 = p1, p2
            gt = torch.softmax(gt, dim=-1)
        return [hap_1, hap_2, gt, h1_before, h2_before, h1_after, h2_after]

    def embed(self, tokens: torch.Tensor, af: torch.Tensor) -> torch.Tensor:
        return self.bert.embed(tokens, af)
