"""Float32 attention with dropout on the attention probabilities, forward
and backward: wrappers of ``csrc/attention_f32.cu``, their plain versions,
and the autograd Function that joins them.

The kernels replace no TPU kernel: they replace the einsum path that
``models/transformer.py::MultiHeadAttention._core`` runs for float32
attention (upstream V18 and V17: 12 or 6 heads of 32, attention dropout
0.1), whose backward keeps the float32 probabilities, the keep mask and
the dropped probabilities ``[B, H, L, L]``.  Here the backward keeps the
row LSE and the mask at one bit a score.  The mask is the one the caller
drew (``models/layers.py::keep_draws``, the draws of ``layers.dropout``),
so the kernels drop exactly the scores the einsum path drops.
``attention_f32`` is differentiable on both devices through
``AttentionF32Fn``: each half takes its plain version for CPU tensors
only; a CUDA tensor goes to the kernels, or the wrapper raises on what
they do not take.  Layout ``[B, H, L, hd]``; the LSE is in base 2, as in
``ops/attention.py``.

How the mask travels.  The model hands the forward its uniform draws, the
float32 ``[B, H, L, L]`` that ``torch.rand`` made (a score is kept where
its draw is at least the rate): the forward kernel compares them as it
walks the keys and writes the mask's bits for the backward, so no bool
mask ``[B, H, L, L]`` is made on the card.  A caller may hand a bool mask
instead (``keep``'s other type): ``pack_keep`` turns it into the bits, and
the forward reads them.  The bits are ``[B, H, L, W]`` int32, ``W =
mask_words(L)``, bit ``c % 32`` of word ``c // 32`` of a row is column
``c`` (1: kept), bits past ``L`` are 0; on the CPU ``pack_keep_plain``
makes them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

HEAD_DIM = 32                  # the one head dim csrc/attention_f32.cu takes
LOG2E = 1.0 / math.log(2.0)
_SIGNATURES = {
    "attention_f32_pack": [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p],
    "attention_f32_fwd": [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_float] * 3
    + [ctypes.c_void_p],
    "attention_f32_bwd": [ctypes.c_void_p] * 12
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
       ctypes.c_void_p],
}


def mask_words(L: int) -> int:
    """32-bit words a row of packed mask bits: two for every 64 columns."""
    return 2 * ((L + 63) // 64)


def pack_keep_plain(keep: torch.Tensor) -> torch.Tensor:
    """The bits of a bool mask ``[..., L]``: int32 ``[..., mask_words(L)]``."""
    L = keep.shape[-1]
    w = mask_words(L)
    padded = torch.zeros(*keep.shape[:-1], w * 32, dtype=torch.int64,
                         device=keep.device)
    padded[..., :L] = keep.long()
    shifts = torch.arange(32, dtype=torch.int64, device=keep.device)
    words = (padded.reshape(*keep.shape[:-1], w, 32) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_keep_plain(bits: torch.Tensor, L: int) -> torch.Tensor:
    """The bool mask ``[..., L]`` of ``pack_keep_plain``'s bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    keep = (bits[..., None] >> shifts) & 1
    return keep.reshape(*bits.shape[:-1], -1)[..., :L].bool()


def _dropped(p: torch.Tensor, keep: torch.Tensor | None, rate: float):
    """``layers.dropout`` of ``p`` with the mask ``keep``."""
    if keep is None:
        return p
    return torch.where(keep, p / (1.0 - rate), torch.zeros((), dtype=p.dtype,
                                                           device=p.device))


def attention_f32_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float,
                            keep: torch.Tensor | None = None,
                            rate: float = 0.0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dropout(softmax(q k^T * scale)) v, lse)`` in float32, the
    dropout the bool mask ``keep`` ``[B, H, L, L]`` (None: none), the LSE
    ``[B, H, L]`` in base 2."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    out = torch.matmul(_dropped(torch.softmax(s, dim=-1), keep, rate), v)
    return out, torch.logsumexp(s, dim=-1) * LOG2E


def attention_f32_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            scale: float, keep: torch.Tensor | None = None,
                            rate: float = 0.0
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``(dq, dk, dv)``, recomputed from the base-2 LSE as the kernels do
    it (not autograd of the forward)."""
    s = torch.matmul(q, k.transpose(-1, -2))
    p = torch.exp2(s * (scale * LOG2E) - lse[..., None])
    dv = torch.matmul(_dropped(p, keep, rate).transpose(-1, -2), do)
    dp = _dropped(torch.matmul(do, v.transpose(-1, -2)), keep, rate)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


def _check(what: str, tensors: dict[str, torch.Tensor]) -> tuple[int, ...]:
    """Raise on what the kernels do not take; return ``(b, h, l, hd)``."""
    q = next(iter(tensors.values()))
    if q.dim() != 4 or any(x.shape != q.shape for x in tensors.values()):
        raise ValueError(f"{what}: {'/'.join(tensors)} must share one "
                         f"[B, H, L, hd] shape, got "
                         f"{[tuple(x.shape) for x in tensors.values()]}")
    b, h, l, hd = q.shape
    if hd != HEAD_DIM:
        raise ValueError(f"{what}: head dim {hd}, the kernels take "
                         f"{HEAD_DIM}")
    if not 1 <= b * h <= 65535 or l < 1:
        raise ValueError(f"{what}: B*H={b * h}, L={l} out of range")
    for name, x in tensors.items():
        if x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"{what}: {name} must be float32 on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             "16-byte aligned")
    if q.device.type != "cuda":
        raise ValueError(f"{what}: the kernels need CUDA tensors, got "
                         f"{q.device}")
    return b, h, l, hd


def _check_aux(what: str, name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: tuple, device) -> None:
    if t.shape != shape or t.dtype != dtype or t.device != device or \
            not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous {dtype} "
                         f"{list(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def pack_keep(keep: torch.Tensor) -> torch.Tensor:
    """The bits of a bool mask ``[..., L]``: the kernel on the card,
    ``pack_keep_plain`` on the CPU."""
    if keep.device.type == "cpu":
        return pack_keep_plain(keep)
    if keep.dtype != torch.bool or keep.dim() < 1 or keep.numel() == 0:
        raise ValueError(f"pack_keep: keep must be a non-empty bool tensor, "
                         f"got {keep.dtype} {tuple(keep.shape)}")
    keep = keep.contiguous()
    L = keep.shape[-1]
    w = mask_words(L)
    bits = torch.empty(*keep.shape[:-1], w, dtype=torch.int32,
                       device=keep.device)
    lib = _build.load("attention_f32", _SIGNATURES)
    with torch.cuda.device(keep.device):
        rc = lib.attention_f32_pack(keep.data_ptr(), bits.data_ptr(),
                                    keep.numel() // L, L, w,
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "attention_f32 pack")
    return bits


def _inv_keep(rate: float) -> float:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention_f32: dropout rate {rate} not in [0, 1)")
    return 1.0 / (1.0 - rate)


def attention_f32_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, keep: torch.Tensor | None = None,
                      rate: float = 0.0, with_lse: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor | None,
                                 torch.Tensor | None]:
    """The forward: ``(out, lse, bits)``.  ``keep`` is dropout at ``rate``
    over ``[B, H, L, L]``: its bool mask, or the float32 uniform draws it
    is made from (kept where the draw ``>= rate``; on the card any strides
    whose last two dims are contiguous), or None (no dropout).  ``bits``
    the mask's packed form for the backward (None without a mask), ``lse``
    None (and written by no one) unless ``with_lse``.  The kernel takes a
    positive ``scale``."""
    inv_keep = _inv_keep(rate)
    if q.device.type == "cpu":
        if keep is not None and keep.dtype != torch.bool:
            keep = keep >= rate
        out, lse = attention_f32_fwd_plain(q, k, v, scale, keep, rate)
        bits = pack_keep_plain(keep) if keep is not None else None
        return out, lse if with_lse else None, bits
    b, h, l, hd = _check("attention_f32", {"q": q, "k": k, "v": v})
    if not scale > 0:
        raise ValueError(f"attention_f32: scale {scale}, the kernel takes a "
                         "positive one")
    draws = bits = None
    if keep is not None and keep.dtype == torch.bool:
        _check_aux("attention_f32", "keep", keep, torch.bool, (b, h, l, l),
                   q.device)
        bits = pack_keep(keep)
    elif keep is not None:
        if keep.dtype != torch.float32 or keep.shape != (b, h, l, l) or \
                keep.device != q.device or keep.stride(3) != 1 or \
                (l > 1 and keep.stride(2) != l):
            raise ValueError(f"attention_f32: keep must be bool, or float32 "
                             f"draws [{b}, {h}, {l}, {l}] on {q.device} with "
                             f"rows of stride {l}, got {keep.dtype} "
                             f"{tuple(keep.shape)} strides {keep.stride()} "
                             f"on {keep.device}")
        draws = keep
        bits = torch.empty(b, h, l, mask_words(l), dtype=torch.int32,
                           device=q.device)
    lib = _build.load("attention_f32", _SIGNATURES)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, l, dtype=torch.float32, device=q.device) \
        if with_lse else None
    with torch.cuda.device(q.device):
        rc = lib.attention_f32_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            draws.data_ptr() if draws is not None else None,
            bits.data_ptr() if bits is not None else None, out.data_ptr(),
            lse.data_ptr() if with_lse else None, b * h, h, l,
            draws.stride(0) if draws is not None else 0,
            draws.stride(1) if draws is not None else 0, float(scale),
            inv_keep if bits is not None else 1.0, float(rate),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "attention_f32")
    attention_f32.launches += 1
    return out, lse, bits


def attention_f32_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      scale: float, bits: torch.Tensor | None = None,
                      rate: float = 0.0
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward: ``(dq, dk, dv)`` from the forward's output, base-2
    LSE and mask bits (None: no dropout) and the output gradient ``do``."""
    inv_keep = _inv_keep(rate)
    if q.device.type == "cpu":
        keep = unpack_keep_plain(bits, q.shape[2]) if bits is not None \
            else None
        return attention_f32_bwd_plain(q, k, v, o, lse, do, scale, keep,
                                       rate)
    b, h, l, hd = _check("attention_f32_bwd",
                         {"q": q, "k": k, "v": v, "o": o, "do": do})
    _check_aux("attention_f32_bwd", "lse", lse, torch.float32, (b, h, l),
               q.device)
    if bits is not None:
        _check_aux("attention_f32_bwd", "bits", bits, torch.int32,
                   (b, h, l, mask_words(l)), q.device)
    lib = _build.load("attention_f32", _SIGNATURES)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dsum = torch.empty(b, h, l, dtype=torch.float32, device=q.device)
    # each block of 128 keys' part of dq, summed in a fixed order by the
    # kernels, over whole tiles of 64 query rows
    dq_parts = torch.empty((l + 127) // 128, b * h, 64 * ((l + 63) // 64),
                           hd, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.attention_f32_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(),
            bits.data_ptr() if bits is not None else None, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(),
            dq_parts.data_ptr(), b * h, l, float(scale),
            inv_keep if bits is not None else 1.0,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "attention_f32_bwd")
    attention_f32_bwd.launches += 1
    return dq, dk, dv


class AttentionF32Fn(torch.autograd.Function):
    """``attention_f32_fwd`` forward, ``attention_f32_bwd`` backward.  The
    forward asks for the LSE (and keeps q, k, v, the output and the mask's
    bits) only when an input needs a gradient, so serving writes none."""

    @staticmethod
    def forward(ctx, q, k, v, keep, scale, rate):
        need = any(ctx.needs_input_grad[:3])
        out, lse, bits = attention_f32_fwd(q, k, v, scale, keep, rate,
                                           with_lse=need)
        if need:
            ctx.save_for_backward(q, k, v, out, lse, bits)
            ctx.scale, ctx.rate = scale, rate
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, bits = ctx.saved_tensors
        dq, dk, dv = attention_f32_bwd(q, k, v, out, lse, do.contiguous(),
                                       ctx.scale, bits, ctx.rate)
        return dq, dk, dv, None, None, None


def attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, keep: torch.Tensor | None = None,
                  rate: float = 0.0) -> torch.Tensor:
    """Fused float32 ``dropout(softmax(q k^T * scale)) v`` over
    ``[B, H, L, hd]``, the dropout at ``rate`` given by ``keep``: its bool
    mask or its float32 draws (``attention_f32_fwd``; None: none),
    differentiable in q, k and v.

    The keys go in less their mean over the sequence.  Shifting every key
    of a head by one vector adds a constant to each row of scores, which
    the softmax removes, so the output and the gradients are the same
    functions of q, k and v.  It matters for dq = scale ds k: the backward
    takes the row sums of ``o * do`` in place of those of ``p * dp``, so a
    row of ds sums to a rounding residue instead of zero, and that residue
    is multiplied by the keys' shared part.  On the keys of upstream V18's
    encoder, that made dq four times further from float64 than the einsum
    path's; with the mean taken out it is within a fifth of it."""
    k = k - k.mean(dim=2, keepdim=True).detach()
    return AttentionF32Fn.apply(q, k, v, keep, scale, rate)


attention_f32.launches = 0
attention_f32_bwd.launches = 0
