"""int8 quantized matmuls for the encoder's Dense layers (AQT-style).

Port of rag_snvbert_tpu/ops/quant.py.  Scheme (symmetric, dynamic, no
calibration state):

  y = (q(x) @ q(w)) * sx * sw,  q(t) = round(clip(t / s, +-127)),
  s = max(amax, 1e-8) / 127

with each scale constant along the contracted axis, so it factors out of
the integer product exactly.  Gradients are straight-through.  Two modes:

  - "fwd": int8 forward product, exact backward products (in the compute
    dtype, as the JAX package's ``int8_dot_fwdonly``);
  - "fwd_bwd" (``int8_matmuls=True``): the two gradient products are
    quantized too (``int8_dot``).

The integer products are ``torch._int_mm`` (int8 x int8 -> int32) on the
card and on the CPU; the JAX package leaves them to XLA's ``dot_general``,
outside any Pallas kernel.  ``_int_mm`` on the card takes row-major A,
column-major B, more than 16 rows and K, N multiples of 8: ``_int_mm``
below pads with zero rows and columns, which change neither products nor
scales.  ``Int8Dense`` has ``models.layers.Dense``'s parameters (``weight
[out, in]``, ``bias``), so an int8 model loads the flax tree of
``rag_snvbert_tpu``'s ``Int8Dense`` unchanged (``interop``); its
``calls`` count every forward, so a run can show that a path went
through it.

Tensor parallelism (``parallel/tp.py`` sets ``Int8Dense.tp``) computes
what GSPMD makes of the JAX products: a scale taken along a split axis is
the max over the group, and an integer product whose contraction is split
is summed over the group in int32 before the rescale.  A column-parallel
layer (``query``/``key``/``value``/``qkv``, ``w_1``: the weight's rows
split) computes its forward locally and sums its input gradient itself
(in int32 with ``"fwd_bwd"``, in the compute dtype with ``"fwd"``); a
row-parallel one (``output``, ``w_2``: the contraction split) sums its
forward before the rescale and the bias.  So each layer's result is the
one-process layer's, bit for bit, with ``"fwd_bwd"``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.layers import Dense, _out_dtype
from ..parallel.comm import all_reduce, all_reduce_max


def _quant(t: torch.Tensor, axis: int, group=None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 along ``axis`` (the contraction axis of the coming
    product): ``(q int8, scale float32 with keepdim)``.  The division is in
    ``t``'s dtype and rounds half to even, as ``jnp.round``.  ``group``:
    ``axis`` is split over it, and the amax is the group's."""
    amax = t.abs().amax(dim=axis, keepdim=True).to(torch.float32)
    if group is not None:
        all_reduce_max(amax, group)
    # a true division: by a Python number the card multiplies by its
    # reciprocal instead, which moves scales by an ulp
    scale = torch.clamp_min(amax, 1e-8) / torch.full(
        (), 127.0, device=t.device)
    q = torch.clamp(torch.round(t / scale.to(t.dtype)), -127, 127)
    return q.to(torch.int8), scale


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``[M, K] @ [K, N]`` -> int32, padded to what ``torch._int_mm``
    takes (M > 16 and every size a multiple of 8; B column-major)."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(24, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return out[:m, :n]


def _int8_matmul(x: torch.Tensor, w: torch.Tensor, group=None
                 ) -> torch.Tensor:
    """``[.., K] @ [K, N]`` on the int8 path, rescaled to x's dtype.
    ``group``: K is split over it."""
    xq, sx = _quant(x, -1, group)              # [.., K], [.., 1]
    wq, sw = _quant(w, 0, group)               # [K, N],  [1, N]
    y = _int_mm(xq.reshape(-1, x.shape[-1]), wq)
    if group is not None:
        y = all_reduce(y.contiguous(), group)  # exact: int32
    y = y.reshape(*x.shape[:-1], w.shape[1])
    return (y.to(torch.float32) * (sx * sw)).to(x.dtype)


def _int8_dx(g: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """dx = g @ w.T quantized: ``[.., N] x [K, N] -> [.., K]`` (contract
    N).  ``group``: N is split over it."""
    gq, sg = _quant(g, -1, group)              # [.., N], [.., 1]
    wq, sw = _quant(w, 1, group)               # [K, N],  [K, 1]
    dx = _int_mm(gq.reshape(-1, g.shape[-1]), wq.t())
    if group is not None:
        dx = all_reduce(dx.contiguous(), group)
    dx = dx.reshape(*g.shape[:-1], w.shape[0])
    return (dx.to(torch.float32) * (sg * sw[:, 0][None, :])).to(g.dtype)


def _int8_dw(x2: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """dw = x.T @ g quantized: ``[M, K] x [M, N] -> [K, N]`` (contract M),
    float32."""
    xq, sx = _quant(x2, 0)                     # [M, K], [1, K]
    gq, sg = _quant(g2, 0)                     # [M, N], [1, N]
    dw = _int_mm(xq.t(), gq)
    return dw.to(torch.float32) * (sx[0][:, None] * sg)


class _Int8Dot(torch.autograd.Function):
    """Quantized ``x @ w`` (``w [K, N]``); backward quantized or exact.
    ``tp``: ``("column", group)`` (N split: x's gradient is summed over
    the group) or ``("row", group)`` (K split: the product is)."""

    @staticmethod
    def forward(ctx, x, w, exact_bwd: bool, tp):
        ctx.save_for_backward(x, w)
        ctx.exact_bwd = exact_bwd
        split, group = tp or (None, None)
        ctx.group = group if split == "column" else None
        return _int8_matmul(x, w, group if split == "row" else None)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf = x.reshape(-1, x.shape[-1])
        gf = g.reshape(-1, g.shape[-1])
        if ctx.exact_bwd:
            dx = g @ w.t()
            if ctx.group is not None:
                all_reduce(dx, ctx.group)
            dw = xf.t() @ gf
        else:
            dx = _int8_dx(g, w, ctx.group)
            dw = _int8_dw(xf, gf)
        return dx.to(g.dtype), dw.to(w.dtype), None, None


def int8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quantized ``x @ w`` with int8 forward AND backward products."""
    return _Int8Dot.apply(x, w, False, None)


def int8_dot_fwdonly(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quantized forward, exact backward in the operands' dtype."""
    return _Int8Dot.apply(x, w, True, None)


class Int8Dense(Dense):
    """``Dense`` with int8 products: the same parameters, computed in
    ``dtype`` (``None``: the promotion of input and parameter types)."""

    calls = 0     # forwards of every Int8Dense, for chip runs' checks

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype | None = None, mode: str = "fwd_bwd"):
        super().__init__(in_features, out_features, dtype)
        if mode not in ("fwd_bwd", "fwd"):
            raise ValueError(f"Int8Dense mode must be 'fwd_bwd' or 'fwd', "
                             f"got {mode!r}")
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        Int8Dense.calls += 1
        dt = _out_dtype(x, self.weight, self.compute_dtype)
        y = _Int8Dot.apply(x.to(dt), self.weight.to(dt).t(),
                           self.mode == "fwd", self.tp)
        return y + self.bias.to(dt)


def dense_cls(quant):
    """``Dense`` or ``Int8Dense``, as the model config asks: ``False`` ->
    ``Dense``; ``True`` / ``"fwd_bwd"`` -> int8 forward and backward;
    ``"fwd"`` -> int8 forward only."""
    if not quant:
        return Dense
    mode = "fwd" if quant == "fwd" else "fwd_bwd"
    return lambda in_features, out_features, dtype=None: Int8Dense(
        in_features, out_features, dtype, mode=mode)
