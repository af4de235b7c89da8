"""Fused attention, forward and backward: wrappers of ``csrc/attention.cu``
and ``csrc/attention_bwd.cu``, their plain versions, and the autograd
Function that joins them.

The kernels replace the splash-attention Pallas kernels that
rag_snvbert_tpu/models/transformer.py::_splash_attention runs in every
encoder layer: the forward, and the fused dq/dkv backward (:141-145).
``attention`` is differentiable on both devices through ``AttentionFn``:
each half takes its plain version for CPU tensors only; a CUDA tensor goes
to the kernel, or the wrapper raises on what the kernel does not take.
Layout ``[B, H, L, hd]``, as in the JAX package.

The LSE that the forward saves for the backward is in base 2:
``lse = log2(sum_j exp2(s_j * scale * log2(e)))``, the natural log-sum-exp
of the scaled scores times log2(e), as the kernel computes it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

HEAD_DIMS = (32, 64, 128)      # template instances in csrc/attention*.cu
LOG2E = 1.0 / math.log(2.0)
_FWD_SIGNATURES = {"attention_fwd_bf16": [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p]}
_BWD_SIGNATURES = {"attention_bwd_bf16": [ctypes.c_void_p] * 10
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p]}


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(softmax(q k^T * scale) v, lse)``: the output in ``q.dtype`` from
    float32 math, the LSE float32 ``[B, H, L]`` in base 2."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    out = torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)
    return out, torch.logsumexp(s, dim=-1) * LOG2E


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` in float32, returned in ``q.dtype``."""
    return attention_fwd_plain(q, k, v, scale)[0]


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in ``q.dtype``, recomputed from the base-2 LSE in
    float32, as the kernel does it (not autograd of the forward)."""
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp2(s * (scale * LOG2E) - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    d = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - d)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check(what: str, tensors: dict[str, torch.Tensor]) -> tuple[int, ...]:
    """Raise on what the kernels do not take; return ``(b, h, l, hd)``."""
    q = next(iter(tensors.values()))
    if q.dim() != 4 or any(x.shape != q.shape for x in tensors.values()):
        raise ValueError(f"{what}: {'/'.join(tensors)} must share one "
                         f"[B, H, L, hd] shape, got "
                         f"{[tuple(x.shape) for x in tensors.values()]}")
    b, h, l, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {HEAD_DIMS}")
    if b * h > 65535 or l < 1:
        raise ValueError(f"{what}: B*H={b * h}, L={l} out of range")
    for name, x in tensors.items():
        if x.dtype != torch.bfloat16 or x.device != q.device:
            raise ValueError(f"{what}: {name} must be bf16 on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             "16-byte aligned")
    return b, h, l, hd


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, with_lse: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The forward half: ``(out, lse)``; ``lse`` is None (and the kernel
    writes none) unless ``with_lse``."""
    if q.device.type == "cpu":
        out, lse = attention_fwd_plain(q, k, v, scale)
        return out, lse if with_lse else None
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    b, h, l, hd = _check("attention", {"q": q, "k": k, "v": v})
    lib = _build.load("attention", _FWD_SIGNATURES)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, l, dtype=torch.float32, device=q.device) \
        if with_lse else None
    with torch.cuda.device(q.device):
        rc = lib.attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b * h, l, hd, float(scale),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "attention")
    attention.launches += 1
    return out, lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward half: ``(dq, dk, dv)`` from the forward's output and
    base-2 LSE and the output gradient ``do``."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd: unsupported device {q.device}")
    b, h, l, hd = _check("attention_bwd",
                         {"q": q, "k": k, "v": v, "o": o, "do": do})
    if lse.shape != (b, h, l) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"attention_bwd: lse must be contiguous float32 "
                         f"[{b}, {h}, {l}] on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    lib = _build.load("attention_bwd", _BWD_SIGNATURES)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dsum = torch.empty(b, h, l, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dsum.data_ptr(), b * h, l, hd, float(scale),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


class AttentionFn(torch.autograd.Function):
    """``attention_fwd`` forward, ``attention_bwd`` backward.  The forward
    asks the kernel for the LSE only when an input needs a gradient, so
    serving writes none."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        need = any(ctx.needs_input_grad[:3])
        out, lse = attention_fwd(q, k, v, scale, with_lse=need)
        if need:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, lse, do.contiguous(),
                                   ctx.scale)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Fused ``softmax(q k^T * scale) v`` over ``[B, H, L, hd]``,
    differentiable in q, k and v."""
    return AttentionFn.apply(q, k, v, scale)


attention.launches = 0
attention_bwd.launches = 0
