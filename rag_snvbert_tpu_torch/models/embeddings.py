"""Embedding stack: haplotype tokens + sinusoidal positions + Fourier AF.

Port of rag_snvbert_tpu/models/embeddings.py.  Submodule names follow the
flax tree (``Embed_0``, ``AFEmbedding_0``, ...) so ``interop.flax_params``
maps it one to one.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..io.vocab import MAX_SEQ_LEN, PAD
from .layers import Dense, LayerNorm, gelu


def sinusoidal_table(max_len: int, dims: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Classic transformer sin/cos table ``[max_len, dims]``, built in
    float32 and then cast to ``dtype`` (as the JAX package does)."""
    position = torch.arange(max_len, dtype=torch.float32,
                            device=device)[:, None]
    div_term = torch.exp(torch.arange(0, dims, 2, dtype=torch.float32,
                                      device=device)
                         * -(math.log(10000.0) / dims))
    ang = position * div_term
    pe = torch.zeros(max_len, dims, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : pe[:, 1::2].shape[1]])
    return pe.to(dtype)


class AFEmbedding(nn.Module):
    """Fourier features ``sin/cos(2*pi*af*f_b)`` over learnable basis
    frequencies, then Dense -> LayerNorm -> GELU -> Dense."""

    def __init__(self, embed_size: int, num_basis: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.basis_freqs = nn.Parameter(torch.logspace(0.0, 2.0, num_basis))
        self.Dense_0 = Dense(2 * num_basis, embed_size, dtype)
        self.LayerNorm_0 = LayerNorm(embed_size, dtype)
        self.Dense_1 = Dense(embed_size, embed_size, dtype)

    def forward(self, af: torch.Tensor) -> torch.Tensor:  # [B, L] -> [B, L, D]
        expanded = af[..., None] * self.basis_freqs
        feats = torch.cat([torch.sin(2 * math.pi * expanded),
                           torch.cos(2 * math.pi * expanded)], dim=-1)
        h = self.Dense_0(feats.to(self.dtype))
        return self.Dense_1(gelu(self.LayerNorm_0(h)))


class BERTEmbedding(nn.Module):
    """Token + positional + AF embeddings, summed, then dropout.

    The PAD row is zeroed by masking the lookup output (torch
    ``padding_idx`` semantics without relying on the stored row)."""

    def __init__(self, vocab_size: int, embed_size: int, dropout: float = 0.1,
                 use_af: bool = True, max_len: int = MAX_SEQ_LEN,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.max_len = max_len
        self.Embed_0 = nn.Embedding(vocab_size, embed_size)
        self.AFEmbedding_0 = AFEmbedding(embed_size, dtype=dtype) \
            if use_af else None
        self.drop = nn.Dropout(dropout)

    def forward(self, seq: torch.Tensor, af: torch.Tensor | None = None,
                pos: bool = True) -> torch.Tensor:
        tok = self.Embed_0(seq).to(self.dtype)
        tok = tok * (seq != PAD)[..., None].to(tok.dtype)
        out = tok
        if pos:
            pe = sinusoidal_table(self.max_len, tok.shape[-1], tok.dtype,
                                  tok.device)
            out = out + pe[None, : seq.shape[-1], :]
        if self.AFEmbedding_0 is not None and af is not None:
            out = out + self.AFEmbedding_0(af.float())
        return self.drop(out)
