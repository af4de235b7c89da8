"""LayerNorm of bf16 activations, forward and backward: wrappers of
``csrc/layer_norm.cu``, their plain versions, and the autograd Function
that joins them.

The kernels replace no TPU kernel (XLA fuses flax's LayerNorm there).  They
replace the chain that ``models/layers.py::LayerNorm`` runs on a bf16
activation, ``x.float()``, ``F.layer_norm`` in float32, ``.to(bfloat16)``,
and its backward; the plain versions are that chain, rounded at the same
points.  ``layer_norm`` is differentiable on both devices: it takes the
plain version for CPU tensors only; a CUDA tensor goes to the kernels
through ``LayerNormFn``, or the wrapper raises on what they do not take.
The rows are every axis but the last; statistics are float32, gamma and
beta float32 ``[D]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

MAX_DIM = 4096                 # csrc/layer_norm.cu: D % 8 == 0, D <= 4096
_SIGNATURES = {
    "layer_norm_fwd_bf16": [ctypes.c_void_p] * 6
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "layer_norm_bwd_parts": [ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)],
    "layer_norm_bwd_bf16": [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """flax's LayerNorm as the port ran it before the kernels: float32
    statistics and affine, the output cast to ``dtype`` (default
    ``x.dtype``)."""
    y = F.layer_norm(x.float(), weight.shape, weight, bias, eps)
    return y.to(x.dtype if dtype is None else dtype)


def layer_norm_bwd_plain(dy: torch.Tensor, x: torch.Tensor,
                         weight: torch.Tensor, bias: torch.Tensor, eps: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dgamma, dbeta)`` of ``layer_norm_plain`` by autograd: ``dy``
    cast up, the float32 LayerNorm backward, ``dx`` cast to ``x.dtype``."""
    with torch.enable_grad():
        xg, wg, bg = (t.detach().requires_grad_() for t in (x, weight, bias))
        y = layer_norm_plain(xg, wg, bg, eps)
        return torch.autograd.grad(y, (xg, wg, bg), dy)


def _check(what: str, tensors: dict[str, torch.Tensor],
           params: dict[str, torch.Tensor]) -> tuple[int, int]:
    """Raise on what the kernels do not take; return ``(rows, D)``."""
    x = next(iter(tensors.values()))
    d = x.shape[-1] if x.dim() else 0
    if d % 8 or not 8 <= d <= MAX_DIM:
        raise ValueError(f"{what}: width {d} is not a multiple of 8 in "
                         f"[8, {MAX_DIM}]")
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"{what}: {rows} rows out of range")
    for name, t in tensors.items():
        if t.shape != x.shape or t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: {'/'.join(tensors)} must be bf16 of "
                             f"one shape, got {name} {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in params.items():
        if t.shape != (d,) or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 [{d}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (*tensors.items(), *params.items()):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             "16-byte aligned")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} must be on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel needs CUDA tensors, got "
                         f"{x.device}")
    return rows, d


@functools.lru_cache(maxsize=None)
def _parts(device_index: int, rows: int, d: int) -> int:
    """Partial rows of dgamma / dbeta the backward writes for ``rows`` x
    ``d`` on this card (its grid: fixed for a shape, so reruns sum in
    the same order)."""
    lib = _build.load("layer_norm", _SIGNATURES)
    parts = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.layer_norm_bwd_parts(rows, d, ctypes.byref(parts))
    _build.check(rc, "layer_norm_bwd")
    return parts.value


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float, with_stats: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor | None,
                              torch.Tensor | None]:
    """The forward kernel: ``(y, mean, rstd)``, y bf16 like ``x``, mean
    and rstd float32 over the rows, None (and written by no one) unless
    ``with_stats``."""
    rows, d = _check("layer_norm", {"x": x},
                     {"weight": weight, "bias": bias})
    y = torch.empty_like(x)
    mean = rstd = None
    if with_stats:
        mean, rstd = (torch.empty(x.shape[:-1], dtype=torch.float32,
                                  device=x.device) for _ in range(2))
    if rows == 0:
        return y, mean, rstd
    lib = _build.load("layer_norm", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.layer_norm_fwd_bf16(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr() if with_stats else None,
            rstd.data_ptr() if with_stats else None, rows, d, float(eps),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "layer_norm")
    layer_norm.launches += 1
    return y, mean, rstd


def layer_norm_bwd(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, weight: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels: ``(dx, dgamma, dbeta)`` from the output
    gradient ``dy``, the forward's input and its mean and rstd; dx bf16,
    dgamma and dbeta float32 ``[D]``."""
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != x.shape[:-1] or t.dtype != torch.float32 or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"layer_norm_bwd: {name} must be contiguous "
                             f"float32 {list(x.shape[:-1])} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    rows, d = _check("layer_norm_bwd", {"dy": dy, "x": x},
                     {"weight": weight})
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, *torch.zeros(2, d, device=x.device)
    parts = _parts(x.device.index, rows, d)
    scratch = torch.empty(2, parts, d, dtype=torch.float32, device=x.device)
    sums = torch.empty(2, d, dtype=torch.float32, device=x.device)
    lib = _build.load("layer_norm", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.layer_norm_bwd_bf16(
            dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            weight.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
            sums.data_ptr(), rows, d, parts,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, sums[0], sums[1]


class LayerNormFn(torch.autograd.Function):
    """``layer_norm_fwd`` forward, ``layer_norm_bwd`` backward.  The
    forward asks the kernel for the row statistics only when an input
    needs a gradient, so serving writes none."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        need = any(ctx.needs_input_grad[:3])
        y, mean, rstd = layer_norm_fwd(x, weight, bias, eps, with_stats=need)
        if need:
            ctx.save_for_backward(x, mean, rstd, weight)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, weight = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(dy.contiguous(), x, mean, rstd,
                                           weight)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dgamma if need[1] else None,
                dbeta if need[2] else None, None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of a bf16 ``x`` into bf16 with float32
    statistics and affine, differentiable in x, weight and bias.  Without
    a gradient to record (serving) the forward kernel is called directly,
    with no autograd node and no statistics."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LayerNormFn.apply(x, weight, bias, eps)
    return layer_norm_fwd(x, weight, bias, eps, with_stats=False)[0]


layer_norm.launches = 0
layer_norm_bwd.launches = 0
