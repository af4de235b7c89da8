"""Fused attention forward: wrapper of ``csrc/attention.cu`` and its plain
version.

The kernel replaces the splash-attention Pallas kernel that
rag_snvbert_tpu/models/transformer.py::_splash_attention runs in every
encoder layer.  ``attention`` takes the plain version for CPU tensors only;
a CUDA tensor goes to the kernel, or the wrapper raises on what the kernel
does not take.  Layout ``[B, H, L, hd]``, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (32, 64, 128)      # template instances in csrc/attention.cu
_SIGNATURES = {"attention_fwd_bf16": [ctypes.c_void_p] * 4
               + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  ctypes.c_void_p]}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` in float32, returned in ``q.dtype``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Fused ``softmax(q k^T * scale) v`` over ``[B, H, L, hd]``."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: q/k/v must share one [B, H, L, hd] "
                         f"shape, got {q.shape}, {k.shape}, {v.shape}")
    b, h, l, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {hd} not in {HEAD_DIMS}")
    if b * h > 65535 or l < 1:
        raise ValueError(f"attention: B*H={b * h}, L={l} out of range")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16 or x.device != q.device:
            raise ValueError(f"attention: {name} must be bf16 on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"attention: {name} must be contiguous and "
                             "16-byte aligned")
    lib = _build.load("attention", _SIGNATURES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            l, hd, float(scale), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "attention")
    attention.launches += 1
    return out


attention.launches = 0
