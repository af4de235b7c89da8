"""Fusion modules: embedding-level feature fusion and the V18 RAG fusion.

Port of rag_snvbert_tpu/models/fusion.py, with the four alternative
fusions (RareVariantAwareFusion, FixedConcatFusion, ConcatFusion,
CrossAttentionFusion, :182-241), which no preset builds.  Activations keep
the JAX layouts (``[B, L, D]``); the position convolutions run in torch's
``[B, C, L]`` internally.  The alternative fusions take no dtype, as in the
JAX package: flax computes them in the promotion of input and float32
parameters (float32), with eps 1e-6 LayerNorms and the tanh GELU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, DenseGeneral, Dropout, LayerNorm, gelu


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
    position channel, with GroupNorm(1) (eps 1e-6, flax's), frozen
    BatchNorm or (``"none"``) nothing between them.  Always float32."""

    def __init__(self, hidden_channels: int = 4, kernel_size: int = 9,
                 norm: str = "group"):
        super().__init__()
        if norm not in ("group", "frozen_batch", "none"):
            # "batch": the JAX model itself cannot apply it (its
            # batch_stats collection is never created)
            raise ValueError(f"unknown pos_norm {norm!r}")
        c, k = hidden_channels, kernel_size
        self.Conv_0 = nn.Conv1d(1, c, k, padding=k // 2)
        self.Conv_1 = nn.Conv1d(c, c, k, padding=k // 2)
        self.Conv_2 = nn.Conv1d(c, 1, k, padding=k // 2)
        self.norm = norm
        if norm == "group":
            self.GroupNorm_0 = nn.GroupNorm(1, c, eps=1e-6)
            self.GroupNorm_1 = nn.GroupNorm(1, c, eps=1e-6)
        elif norm == "frozen_batch":
            self.FrozenBatchNorm_0 = FrozenBatchNorm(c)
            self.FrozenBatchNorm_1 = FrozenBatchNorm(c)

    def _norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.norm == "none":
            return x
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
        self.drop = Dropout(dropout)

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


class RareVariantAwareFusion(nn.Module):
    """Alternative fusion (JAX fusion.py:182-196): an AF-gated weight
    broadcast over the K references, 0.7 mean + 0.3 max pooling,
    ``gelu(LN(Dense([orig, pooled])))`` scaled by ``sqrt(af (1 - af))``."""

    def __init__(self, dims: int):
        super().__init__()
        self.Dense_0 = Dense(1, 16)
        self.Dense_1 = Dense(16, dims)
        self.Dense_2 = Dense(2 * dims, dims)
        self.LayerNorm_0 = LayerNorm(dims)

    def forward(self, orig_feat: torch.Tensor, rag_feat: torch.Tensor,
                af: torch.Tensor) -> torch.Tensor:
        # orig_feat [B, L, D]; rag_feat [B, K, L, D]; af [B, L]
        w = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(af[..., None]))))
        weighted = rag_feat * w[:, None].to(rag_feat.dtype)
        pooled = 0.7 * weighted.mean(dim=1) + 0.3 * weighted.amax(dim=1)
        fused = gelu(self.LayerNorm_0(self.Dense_2(
            torch.cat([orig_feat, pooled], dim=-1))))
        maf_w = torch.sqrt(af * (1 - af))[..., None]
        return orig_feat + fused * maf_w.to(fused.dtype)


class FixedConcatFusion(nn.Module):
    """Mean pooling, concat, 0.1-scaled residual (JAX fusion.py:199-209)."""

    def __init__(self, dims: int):
        super().__init__()
        self.Dense_0 = Dense(2 * dims, dims)
        self.LayerNorm_0 = LayerNorm(dims)

    def forward(self, orig_feat: torch.Tensor,
                rag_feat: torch.Tensor) -> torch.Tensor:
        fused = torch.cat([orig_feat, rag_feat.mean(dim=1)], dim=-1)
        return orig_feat + 0.1 * gelu(self.LayerNorm_0(self.Dense_0(fused)))


class ConcatFusion(nn.Module):
    """0.5 mean + 0.5 max pooling, a Dense fuse (the reference's 1x1
    conv), residual (JAX fusion.py:212-222)."""

    def __init__(self, dims: int):
        super().__init__()
        self.Dense_0 = Dense(2 * dims, dims)

    def forward(self, orig_feat: torch.Tensor,
                rag_feat: torch.Tensor) -> torch.Tensor:
        pooled = 0.5 * rag_feat.mean(dim=1) + 0.5 * rag_feat.amax(dim=1)
        return orig_feat + self.Dense_0(torch.cat([orig_feat, pooled],
                                                  dim=-1))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` as ``CrossAttentionFusion``
    builds it (``qkv_features = out_features = D``, dropout rate 0, no
    mask): ``DenseGeneral`` projections named ``query``/``key``/``value``
    (``[D] -> [H, hd]``) and ``out`` (``[H, hd] -> [D]``); the query is
    divided by ``sqrt(hd)`` before the product, and the softmax is taken in
    the computation dtype (float32 from float32 parameters)."""

    def __init__(self, dims: int, heads: int):
        super().__init__()
        if dims % heads:
            raise ValueError(f"dims {dims} not divisible by heads {heads}")
        hd = dims // heads
        self.query = DenseGeneral((dims,), (heads, hd))
        self.key = DenseGeneral((dims,), (heads, hd))
        self.value = DenseGeneral((dims,), (heads, hd))
        self.out = DenseGeneral((heads, hd), (dims,))

    def forward(self, inputs_q: torch.Tensor,
                inputs_kv: torch.Tensor) -> torch.Tensor:
        q = self.query(inputs_q)                 # [N, Lq, H, hd]
        k, v = self.key(inputs_kv), self.value(inputs_kv)
        q = q / torch.sqrt(torch.tensor(q.shape[-1], dtype=q.dtype))
        w = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q, k), dim=-1)
        return self.out(torch.einsum("nhqk,nkhd->nqhd", w, v))


class CrossAttentionFusion(nn.Module):
    """Cross attention of the query sequence to each retrieved reference,
    averaged over K (JAX fusion.py:225-241; K folded into the batch)."""

    def __init__(self, dims: int, heads: int = 8):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dims, heads)

    def forward(self, orig_feat: torch.Tensor,
                rag_feat: torch.Tensor) -> torch.Tensor:
        b, k, l, d = rag_feat.shape
        q = orig_feat[:, None].expand(b, k, l, d).reshape(b * k, l, d)
        out = self.MultiHeadDotProductAttention_0(
            q, rag_feat.reshape(b * k, l, d))
        return orig_feat + out.reshape(b, k, l, d).mean(dim=1)
