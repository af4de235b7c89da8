"""Planar bit-packing of small-integer vectors for ``l2_topk_rf``'s
``pack > 1`` path, and the TPU kernel's tile rules that fix an aligned
index's padded shape.

Copy of rag_snvbert_tpu/ops/l2_topk_pallas.py:140-192 (``pack_planar``,
``planar_unpack``, ``planar_sq_norms``); the outputs are bit-identical.
``v [N, d]`` with values in ``[0, 2^(8/pack))`` packs into int8 ``[N, D8]``
with ``D8 = round_up(max(ceil(d / pack), 128), 128)``: byte column ``j``
holds original columns ``{j + m * D8 : m < pack}`` at bit offset
``m * (8 / pack)``, so each bit-plane is a contiguous block of original
columns (plane ``m`` of byte columns ``[c0, c0 + w)`` is the unpacked block
``[m * D8 + c0, m * D8 + c0 + w)``).  pack 8: binary genotypes; pack 4:
dosage 0..3; pack 2: small ints 0..15.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PACKS = (2, 4, 8)


# ---- the padded shape of an aligned index ----
# Copies of rag_snvbert_tpu/ops/l2_topk_pallas.py:112-137.  The CUDA
# kernels need no TPU tiles; FlatL2Index.build(align=True) pads to them so
# that both packages write and read the same npz files.  ``dtype`` is a
# torch dtype or "int4" (one byte a value in the port's storage).

def _itemsize(dtype) -> int:
    return 1 if dtype == "int4" else dtype.itemsize


def default_td(d: int, dtype) -> int:
    """The TPU kernel's d tile: 2048 columns for 1-2 byte values, 1024 for
    4, at most d rounded up to 128."""
    td = 2048 if _itemsize(dtype) <= 2 else 1024
    return min(td, -(-max(d, 128) // 128) * 128)


def default_tn(dtype) -> int:
    """The TPU kernel's ref tile: 2048 rows for 1-byte values, else 1024."""
    return 2048 if _itemsize(dtype) == 1 else 1024


def ref_alignment(d: int, dtype, tn: int | None = None) -> tuple[int, int]:
    """(row multiple, padded d) of an aligned index of ``d`` columns."""
    if tn is None:
        tn = default_tn(dtype)
    td = default_td(d, dtype)
    return tn, -(-max(d, 128) // td) * td


def packed_width(d: int, pack: int) -> int:
    """``D8``: the packed row width in bytes for ``d`` original columns."""
    return -(-max(-(-d // pack), 128) // 128) * 128


def pack_planar(v: torch.Tensor, pack: int) -> torch.Tensor:
    """``[N, d]`` small non-negative ints -> planar-packed int8 ``[N, D8]``
    (stays in uint8 end to end, as the JAX version does)."""
    if pack not in PACKS:
        raise ValueError(f"pack must be one of {PACKS}, got {pack}")
    n, d = v.shape
    bits = 8 // pack
    d8 = packed_width(d, pack)
    vp = F.pad(v.to(torch.uint8), (0, d8 * pack - d))
    planes = vp.reshape(n, pack, d8)
    packed = planes[:, 0, :].clone()
    for m in range(1, pack):
        packed |= planes[:, m, :] << (m * bits)
    return packed.view(torch.int8)


def _planes(packed: torch.Tensor, pack: int) -> list[torch.Tensor]:
    bits = 8 // pack
    mask = (1 << bits) - 1
    p32 = packed.to(torch.int32)
    return [(p32 >> (m * bits)) & mask for m in range(pack)]


def planar_unpack(packed: torch.Tensor, pack: int, d: int) -> torch.Tensor:
    """Inverse of ``pack_planar`` -> int8 ``[N, d]``."""
    planes = [p.to(torch.int8) for p in _planes(packed, pack)]
    return torch.cat(planes, dim=1)[:, :d]


def planar_sq_norms(packed: torch.Tensor, pack: int) -> torch.Tensor:
    """``[N]`` float32 squared norms of planar-packed vectors."""
    acc = torch.zeros(packed.shape[0], dtype=torch.int32,
                      device=packed.device)
    for plane in _planes(packed, pack):
        acc += (plane * plane).sum(dim=1, dtype=torch.int32)
    return acc.to(torch.float32)
