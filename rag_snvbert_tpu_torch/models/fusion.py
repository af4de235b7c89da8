"""Fusion modules: embedding-level feature fusion and the V18 RAG fusion.

Port of rag_snvbert_tpu/models/fusion.py:33-179.  The four alternative
fusions of that file (RareVariantAwareFusion, FixedConcatFusion,
ConcatFusion, CrossAttentionFusion) are not ported yet.  Activations keep
the JAX layouts (``[B, L, D]``); the position convolutions run in torch's
``[B, C, L]`` internally.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNorm, gelu


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm over channel axis 1 whose statistics come
    with the weights (converted reference checkpoints)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def reset_stats(self) -> None:
        """The identity: weight 1, bias 0, mean 0, var 1."""
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, L]
        inv = torch.rsqrt(self.var + self.eps) * self.weight
        return (x - self.mean[:, None]) * inv[:, None] + self.bias[:, None]


class PositionFeatModule(nn.Module):
    """Three Conv1d(k=9, "SAME") + LeakyReLU(0.05) over the normalised
    position channel, with GroupNorm(1) (eps 1e-6, flax's) or frozen
    BatchNorm between them.  Always float32."""

    def __init__(self, hidden_channels: int = 4, kernel_size: int = 9,
                 norm: str = "group"):
        super().__init__()
        if norm not in ("group", "frozen_batch"):
            raise NotImplementedError(f"pos_norm={norm!r} is not ported yet")
        c, k = hidden_channels, kernel_size
        self.Conv_0 = nn.Conv1d(1, c, k, padding=k // 2)
        self.Conv_1 = nn.Conv1d(c, c, k, padding=k // 2)
        self.Conv_2 = nn.Conv1d(c, 1, k, padding=k // 2)
        self.norm = norm
        if norm == "group":
            self.GroupNorm_0 = nn.GroupNorm(1, c, eps=1e-6)
            self.GroupNorm_1 = nn.GroupNorm(1, c, eps=1e-6)
        else:
            self.FrozenBatchNorm_0 = FrozenBatchNorm(c)
            self.FrozenBatchNorm_1 = FrozenBatchNorm(c)

    def _norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        name = "GroupNorm" if self.norm == "group" else "FrozenBatchNorm"
        return getattr(self, f"{name}_{i}")(x)

    def forward(self, pos: torch.Tensor) -> torch.Tensor:  # [B, L] -> [B, L]
        h = pos[:, None, :].float()
        h = self._norm(0, F.leaky_relu(self.Conv_0(h), 0.05))
        h = self._norm(1, F.leaky_relu(self.Conv_1(h), 0.05))
        return F.leaky_relu(self.Conv_2(h), 0.05)[:, 0]


class EmbeddingFusionModule(nn.Module):
    """``LN(emb + LeakyReLU(Dense([emb, pos_feat, af])))``."""

    def __init__(self, emb_size: int, pos_norm: str = "group",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_feat = PositionFeatModule(norm=pos_norm)
        self.fusion = Dense(emb_size + 2, emb_size, dtype)
        self.LayerNorm_0 = LayerNorm(emb_size, dtype)

    def forward(self, emb: torch.Tensor, pos: torch.Tensor,
                af: torch.Tensor) -> torch.Tensor:
        pos_feat = self.pos_feat(pos)[..., None].to(emb.dtype)
        af_feat = af[..., None].to(emb.dtype)
        all_feat = torch.cat([emb, pos_feat, af_feat], dim=-1)
        all_feat = F.leaky_relu(self.fusion(all_feat), 0.1)
        return self.LayerNorm_0(emb + all_feat)


class CrossAFInteraction(nn.Module):
    """Gated interaction of global and population allele frequencies."""

    def __init__(self, dims: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = Dense(2, 32, dtype)
        self.Dense_1 = Dense(32, dims, dtype)
        self.Dense_2 = Dense(2, dims, dtype)
        self.LayerNorm_0 = LayerNorm(dims, dtype)
        self.res_scale = nn.Parameter(torch.tensor(0.1))

    def forward(self, global_af: torch.Tensor,
                pop_af: torch.Tensor) -> torch.Tensor:
        combined = torch.stack([global_af, pop_af], dim=-1).to(self.dtype)
        gate = torch.sigmoid(self.Dense_1(gelu(self.Dense_0(combined))))
        enc = gelu(self.LayerNorm_0(self.Dense_2(combined)))
        return (global_af[..., None].to(self.dtype)
                + self.res_scale.to(self.dtype) * (gate * enc))


class EnhancedRareVariantFusion(nn.Module):
    """V18 RAG fusion: AF-weighted softmax pooling over the K retrieved
    references, concat-MLP fuse, MAF-inverse log1p residual."""

    def __init__(self, dims: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.af_interaction = CrossAFInteraction(dims, dtype)
        self.Dense_0 = Dense(dims, 4 * dims, dtype)
        self.Dense_1 = Dense(4 * dims, dims, dtype)
        self.pooling = Dense(dims, 1, dtype)
        self.Dense_2 = Dense(2 * dims, 4 * dims, dtype)
        self.Dense_3 = Dense(4 * dims, dims, dtype)
        self.LayerNorm_0 = LayerNorm(dims, dtype)
        self.res_scale = nn.Parameter(torch.tensor(0.1))
        self.drop = nn.Dropout(dropout)

    def forward(self, orig_feat: torch.Tensor, rag_feat: torch.Tensor,
                global_af: torch.Tensor,
                pop_af: torch.Tensor) -> torch.Tensor:
        # orig_feat [B, L, D]; rag_feat [B, K, L, D]
        fused_af = self.af_interaction(global_af, pop_af)
        w = self.drop(gelu(self.Dense_0(fused_af)))
        af_weight = torch.sigmoid(self.Dense_1(w))
        weighted = rag_feat * af_weight[:, None].to(rag_feat.dtype)
        weighted = weighted.transpose(1, 2)                  # [B, L, K, D]
        pool_w = torch.softmax(self.pooling(weighted), dim=2)
        pooled = (weighted * pool_w).sum(dim=2)
        fused = torch.cat([orig_feat, pooled], dim=-1)
        fused = self.drop(gelu(self.Dense_2(fused)))
        fused = self.LayerNorm_0(self.Dense_3(fused))
        maf = torch.minimum(global_af, 1.0 - global_af)[..., None]
        maf_weight = torch.clamp(torch.log1p(1.0 / (maf + 1e-6)), max=3.0)
        # The float32 res_scale is NOT cast (fusion.py:179): in JAX the
        # product promotes to float32, so this module returns float32.
        # torch would keep bf16 for a 0-d operand, hence the explicit casts.
        res = (fused * maf_weight.to(fused.dtype)).float()
        return orig_feat.float() + self.res_scale * res
