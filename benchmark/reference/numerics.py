"""The precision a reference product is computed in.

``None`` is float32 (the reference).  The controls round each product's
operands first and accumulate in float32, as the lower-precision unit
would: ``"tf32"`` to 10 mantissa bits (what a TF32 tensor core reads),
``"fp8"`` to float8 e4m3 with one scale per tensor (amax to 448, the
usual per-tensor scaling)."""

from __future__ import annotations

import torch


def _tf32(x: torch.Tensor) -> torch.Tensor:
    b = x.contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & ~0x1FFF
    return b.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def round_operand(x: torch.Tensor, mode: str | None) -> torch.Tensor:
    """``x`` (float32) as the product of ``mode`` reads it; the gradient
    passes straight through the rounding."""
    if mode is None:
        return x
    fn = {"tf32": _tf32, "fp8": _fp8}[mode]
    with torch.no_grad():
        r = fn(x.float())
    return x + (r - x).detach()


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str | None):
    return torch.matmul(round_operand(a, mode), round_operand(b, mode))


def linear(x, w, bias, mode: str | None):
    y = torch.matmul(round_operand(x, mode), round_operand(w, mode).t())
    return y + bias
