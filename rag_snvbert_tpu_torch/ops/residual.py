"""The pre-LN block's residual epilogue of bf16 activations, forward and
backward: wrappers of ``csrc/residual.cu``, their plain versions, and the
autograd Function that joins them.

The kernels replace no TPU kernel (XLA fuses the LeakyReLU, the residual
dropouts and the add there).  They replace the chain that a pre-LN
``models/transformer.py::TransformerBlock`` runs after each sublayer,
``y = x + drop_n(... drop_1(act(f)))``: ``act`` the identity (after
attention) or LeakyReLU(0.1) (after the FFN's ``w_2``), each dropout a
scaled copy and a ``where`` against its keep mask, then the add; the plain
version is that chain, op for op.  The masks are bool ``[B, 1, D]`` (one
mask along the sequence, the model's ``dropout_broadcast``), in the order
the chain applies them, each with its rate.  ``residual`` is
differentiable on both devices: it takes the plain version for CPU tensors
only; a CUDA tensor goes to the kernels through ``ResidualFn``, or the
wrapper raises on what they do not take.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

MAX_DIM = 4096                 # csrc/residual.cu: D % 8 == 0, D <= 4096
MAX_MASKS = 2
_SIGNATURES = {
    name: [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_float,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    for name in ("residual_fwd_bf16", "residual_bwd_bf16")}


def keep_scaled(t: torch.Tensor, keep: torch.Tensor,
                rate: float) -> torch.Tensor:
    """Dropout with a drawn ``keep`` mask: the kept elements of ``t``
    divided by ``1 - rate``, the others 0 (``models.layers.dropout``)."""
    return torch.where(keep, t / (1.0 - rate),
                       torch.zeros((), dtype=t.dtype, device=t.device))


def residual_plain(x: torch.Tensor, f: torch.Tensor, masks=(), rates=(),
                   leaky: bool = False) -> torch.Tensor:
    """The chain: ``x + keep_scaled(... keep_scaled(act(f), masks[0],
    rates[0]) ..., masks[-1], rates[-1])``."""
    t = F.leaky_relu(f, 0.1) if leaky else f
    for keep, rate in zip(masks, rates, strict=True):
        t = keep_scaled(t, keep, rate)
    return x + t


def residual_bwd_plain(g: torch.Tensor, f: torch.Tensor | None, masks=(),
                       rates=(), leaky: bool = False) -> torch.Tensor:
    """The gradient of ``residual_plain`` in ``f`` by autograd (``f`` read
    only under LeakyReLU)."""
    with torch.enable_grad():
        fg = (g if f is None else f).detach().requires_grad_()
        y = residual_plain(torch.zeros_like(fg), fg, masks, rates, leaky)
        return torch.autograd.grad(y, fg, g)[0]


def scale_of(rate: float) -> float:
    """``1 / (1 - rate)`` as the card's chain multiplies by it: the float32
    reciprocal of the float32 ``1 - rate``."""
    with np.errstate(divide="ignore"):
        return float(np.float32(1.0) / np.float32(1.0 - rate))


def _check(what: str, tensors: dict[str, torch.Tensor], masks) -> None:
    """Raise on what the kernels do not take."""
    x = next(iter(tensors.values()))
    if x.dim() != 3:
        raise ValueError(f"{what}: {'/'.join(tensors)} must be [B, L, D], "
                         f"got {tuple(x.shape)}")
    b, _, d = x.shape
    if d % 8 or not 8 <= d <= MAX_DIM:
        raise ValueError(f"{what}: width {d} is not a multiple of 8 in "
                         f"[8, {MAX_DIM}]")
    if not 1 <= b <= 65535 or x.shape[1] < 1:
        raise ValueError(f"{what}: shape {tuple(x.shape)} out of range")
    for name, t in tensors.items():
        if t.shape != x.shape or t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: {'/'.join(tensors)} must be bf16 of "
                             f"one shape, got {name} {t.dtype} "
                             f"{tuple(t.shape)}")
    if len(masks) > MAX_MASKS:
        raise ValueError(f"{what}: at most {MAX_MASKS} masks, got "
                         f"{len(masks)}")
    for i, m in enumerate(masks):
        if m.shape != (b, 1, d) or m.dtype != torch.bool:
            raise ValueError(f"{what}: mask {i} must be bool [{b}, 1, {d}], "
                             f"got {m.dtype} {tuple(m.shape)}")
    named = (*tensors.items(), *((f"mask {i}", m) for i, m in
                                 enumerate(masks)))
    for name, t in named:
        if not t.is_contiguous() or t.data_ptr() % (
                8 if name.startswith("mask") else 16):
            raise ValueError(f"{what}: {name} must be contiguous and "
                             "aligned")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} must be on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the kernel needs CUDA tensors, got "
                         f"{x.device}")


def _launch(fn: str, a: torch.Tensor, f: torch.Tensor | None, masks,
            rates, leaky: bool) -> torch.Tensor:
    out = torch.empty_like(a)
    b, l, d = a.shape
    scales = [scale_of(r) for r in rates] + [1.0] * (MAX_MASKS - len(rates))
    ptrs = [m.data_ptr() for m in masks] + [None] * (MAX_MASKS - len(masks))
    lib = _build.load("residual", _SIGNATURES)
    with torch.cuda.device(a.device):
        rc = getattr(lib, fn)(
            a.data_ptr(), None if f is None else f.data_ptr(), *ptrs,
            *scales, len(masks), int(leaky), out.data_ptr(), b, l, d,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, fn)
    return out


def residual_fwd(x: torch.Tensor, f: torch.Tensor, masks=(), rates=(),
                 leaky: bool = False) -> torch.Tensor:
    """The forward kernel: ``y`` bf16 like ``x``."""
    if len(masks) != len(rates):
        raise ValueError("residual: one rate a mask")
    _check("residual", {"x": x, "f": f}, masks)
    y = _launch("residual_fwd_bf16", x, f, masks, rates, leaky)
    residual.launches += 1
    return y


def residual_bwd(g: torch.Tensor, f: torch.Tensor | None, masks=(),
                 rates=(), leaky: bool = False) -> torch.Tensor:
    """The backward kernel: the gradient of ``f`` from the gradient ``g``
    of ``y``, the forward's masks and rates and, under LeakyReLU, its
    ``f`` (not read otherwise).  With neither a mask nor LeakyReLU it is
    ``g`` itself, and nothing launches."""
    if len(masks) != len(rates):
        raise ValueError("residual_bwd: one rate a mask")
    if leaky and f is None:
        raise ValueError("residual_bwd: LeakyReLU needs the forward's f")
    _check("residual_bwd", {"g": g, **({"f": f} if leaky else {})}, masks)
    if not masks and not leaky:
        return g
    gf = _launch("residual_bwd_bf16", g, f if leaky else None, masks, rates,
                 leaky)
    residual_bwd.launches += 1
    return gf


class ResidualFn(torch.autograd.Function):
    """``residual_fwd`` forward, ``residual_bwd`` backward.  The gradient
    of ``x`` is the output's gradient itself; the backward keeps the masks
    and, under LeakyReLU, ``f``."""

    @staticmethod
    def forward(ctx, x, f, rates, leaky, *masks):
        y = residual_fwd(x, f, masks, rates, leaky)
        ctx.save_for_backward(f if leaky else None, *masks)
        ctx.rates, ctx.leaky = rates, leaky
        return y

    @staticmethod
    def backward(ctx, g):
        f, *masks = ctx.saved_tensors
        need = ctx.needs_input_grad
        gf = residual_bwd(g.contiguous(), f, masks, ctx.rates,
                          ctx.leaky) if need[1] else None
        return (g if need[0] else None, gf, None, None,
                *(None for _ in masks))


def residual(x: torch.Tensor, f: torch.Tensor, masks=(), rates=(),
             leaky: bool = False) -> torch.Tensor:
    """``x + drop_n(... drop_1(act(f)))`` of bf16 ``x`` and ``f`` of one
    shape ``[B, L, D]``: ``act`` LeakyReLU(0.1) where ``leaky``, else the
    identity; dropout ``k`` keeps where ``masks[k]`` (bool ``[B, 1, D]``)
    and scales by ``1 / (1 - rates[k])``.  Differentiable in x and f.
    Without a gradient to record (serving) the forward kernel is called
    directly, with no autograd node."""
    masks, rates = tuple(masks), tuple(rates)
    if x.device.type == "cpu":
        return residual_plain(x, f, masks, rates, leaky)
    if torch.is_grad_enabled() and (x.requires_grad or f.requires_grad):
        return ResidualFn.apply(x, f, rates, leaky, *masks)
    return residual_fwd(x, f, masks, rates, leaky)


residual.launches = 0
residual_bwd.launches = 0
