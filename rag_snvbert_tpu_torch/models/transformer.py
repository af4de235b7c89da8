"""Transformer encoder: multi-head attention, feed-forward, blocks (post-LN
reference topology or pre-LN), and the layer stack.

Port of rag_snvbert_tpu/models/transformer.py.  Attention takes the fused
kernel (``ops/attention.py``) where the JAX package takes its Pallas kernel
(``flash_attention`` set, attention dropout 0, no mask,
transformer.py:207-208); otherwise the plain torch math below, the twin of
the JAX einsum path (:220-233).  The layer stack is an unrolled loop: no
scan, no remat, and no pad-once residency (:379-399 pads to TPU block
multiples; the CUDA kernel masks the ragged tail itself).  ``quant`` (the
model's ``int8_matmuls``) builds every projection as ``ops.quant``'s
``Int8Dense`` (:191-192, :249-250).  ``tp_group`` (set by
``parallel/tp.py``'s ``shard_model``) makes attention and the FFN
Megatron-parallel: each rank holds whole heads of query/key/value (or
``qkv``) and a slice of ``w_1``, and the row-parallel ``output`` and
``w_2`` products are summed over the group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .layers import Dropout, LayerNorm, row_parallel


class MultiHeadAttention(nn.Module):
    def __init__(self, heads: int, dims: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 attn_dropout: float | None = None, flash: bool = False,
                 score_dtype: torch.dtype = torch.float32,
                 fused_qkv: bool = False, quant: bool | str = False):
        super().__init__()
        from ..ops.quant import dense_cls   # ops.quant imports models.layers

        Dense = dense_cls(quant)
        if dims % heads:
            raise ValueError(f"dims {dims} not divisible by heads {heads}")
        self.heads, self.dims, self.dtype = heads, dims, dtype
        self.attn_rate = dropout if attn_dropout is None else attn_dropout
        self.attn_drop = Dropout(self.attn_rate)
        self.flash = flash
        self.score_dtype = score_dtype
        self.fused_qkv = fused_qkv
        if fused_qkv:
            self.qkv = Dense(dims, 3 * dims, dtype)
        else:
            self.query = Dense(dims, dims, dtype)
            self.key = Dense(dims, dims, dtype)
            self.value = Dense(dims, dims, dtype)
        self.output = Dense(dims, dims, dtype)
        self.tp_group = None
        self.local_heads = heads       # this rank's heads (tensor parallel)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        b, l, _ = x.shape
        hd = self.dims // self.heads
        heads = self.local_heads
        if self.tp_group is not None:
            from ..parallel.comm import copy_to_group

            x = copy_to_group(x, self.tp_group)
        if self.fused_qkv:
            qkv = self.qkv(x).reshape(b, l, 3, heads, hd)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            def proj(layer):
                return layer(x).reshape(b, l, heads, hd).transpose(1, 2)

            q, k, v = proj(self.query), proj(self.key), proj(self.value)

        if self.flash and mask is None and self.attn_rate == 0.0:
            out = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            1.0 / float(hd) ** 0.5)
        else:
            sd = self.score_dtype
            score = torch.matmul(q.to(sd), k.to(sd).transpose(-1, -2))
            score = score / torch.sqrt(torch.tensor(hd, dtype=sd))
            if mask is not None:
                score = score.masked_fill(mask == 0, -1e9)
            probs = torch.softmax(score, dim=-1).to(self.dtype)
            probs = self.attn_drop(probs)
            out = torch.matmul(probs, v)
        out = out.transpose(1, 2).reshape(b, l, heads * hd)
        return row_parallel(self.output, out, self.tp_group)


class FeedForward(nn.Module):
    """Dense -> LeakyReLU(0.1) -> LayerNorm -> Dense -> LeakyReLU(0.1) ->
    dropout."""

    def __init__(self, dims: int, hidden_dims: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 dropout_broadcast: bool = False, quant: bool | str = False):
        super().__init__()
        from ..ops.quant import dense_cls

        Dense = dense_cls(quant)
        self.w_1 = Dense(dims, hidden_dims, dtype)
        self.LayerNorm_0 = LayerNorm(hidden_dims, dtype)
        self.w_2 = Dense(hidden_dims, dims, dtype)
        self.drop = Dropout(dropout, dropout_broadcast)
        self.tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            from ..parallel.comm import copy_to_group

            x = copy_to_group(x, self.tp_group)
        h = self.LayerNorm_0(F.leaky_relu(self.w_1(x), 0.1))
        h = F.leaky_relu(row_parallel(self.w_2, h, self.tp_group), 0.1)
        return self.drop(h)


class TransformerBlock(nn.Module):
    """``pre_ln=False``: the reference's ``dropout(LN(x + f(x)))`` per
    sublayer plus a trailing dropout; ``pre_ln=True``: standard pre-norm."""

    def __init__(self, dims: int, attn_heads: int, feed_forward_hidden: int,
                 dropout: float = 0.1, pre_ln: bool = False,
                 dtype: torch.dtype = torch.float32,
                 attn_dropout: float | None = None, flash: bool = False,
                 score_dtype: torch.dtype = torch.float32,
                 dropout_broadcast: bool = False, fused_qkv: bool = False,
                 quant: bool | str = False):
        super().__init__()
        self.dtype, self.pre_ln = dtype, pre_ln
        self.drop = Dropout(dropout, dropout_broadcast)
        self.attention = MultiHeadAttention(
            attn_heads, dims, dropout, dtype, attn_dropout, flash,
            score_dtype, fused_qkv, quant)
        self.feed_forward = FeedForward(dims, feed_forward_hidden, dropout,
                                        dtype, dropout_broadcast, quant)
        self.LayerNorm_0 = LayerNorm(dims, dtype)
        self.LayerNorm_1 = LayerNorm(dims, dtype)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.pre_ln:
            x = x + self.drop(self.attention(self.LayerNorm_0(x), mask))
            return x + self.drop(self.feed_forward(self.LayerNorm_1(x)))
        x = self.drop(self.LayerNorm_0(x + self.attention(x, mask)))
        x = self.drop(self.LayerNorm_1(x + self.feed_forward(x)))
        return self.drop(x)


class Encoder(nn.Module):
    """``n_layers`` blocks named ``block_{i}`` (the flax tree's names)."""

    def __init__(self, n_layers: int, dims: int, attn_heads: int,
                 dropout: float = 0.1, pre_ln: bool = False,
                 dtype: torch.dtype = torch.float32,
                 attn_dropout: float | None = None, flash: bool = False,
                 score_dtype: torch.dtype = torch.float32,
                 dropout_broadcast: bool = False, fused_qkv: bool = False,
                 quant: bool | str = False):
        super().__init__()
        self.dtype = dtype
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                dims, attn_heads, 4 * dims, dropout, pre_ln, dtype,
                attn_dropout, flash, score_dtype, dropout_broadcast,
                fused_qkv, quant))

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, mask)
        return x
