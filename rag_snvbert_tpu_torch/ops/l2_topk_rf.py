"""Exact squared-L2 top-k over int8 vectors: wrapper of
``csrc/l2_topk_rf.cu`` and its plain version.

The kernel replaces rag_snvbert_tpu/ops/l2_topk_pallas.py::_l2_topk_kernel_rf,
the refs-outer kernel that ``l2_topk_pallas`` takes for integer vectors
whose d fits one tile (the V17 token search, the genotype index).  The
semantics are those of ``l2_topk_pallas`` with integer inputs
(:518-566): int8 queries ``[B, d]`` against int8 refs ``[N, d]``, or
planar-packed refs ``[N, D8]`` (``ops.planar.pack_planar``, ``pack`` 2/4/8)
whose unpacked width ``D8 * pack`` the queries are zero-padded to;
``r_norms [N]`` float32 squared norms, ``+inf`` on rows never returned
ahead of a finite one.  Returns ``(vals [B, k] float32 exact integer
distances, ids [B, k] int32)``, ascending, ties to the lower id.

Differences from the TPU kernel (README.md, port section):
  - distances are exact and unclamped; the TPU kernel clamps them at
    ``2^20 - 1`` and never returns a clamped row (:86-92, :599-603);
  - queries are not pre-doubled, so every int8 value is exact (the TPU
    kernel needs ``|q| <= 63``);
  - ``+inf`` rows rank after every finite row in id order, and slots past
    the last row hold ``(+inf, -1)`` (the TPU kernel leaves ``(+inf, 0)``
    once the finite rows run out).
Pass 1 is a warp-specialized TMA/mbarrier ring feeding int8 wgmma products,
with the selection as the products' epilogue; this module plans the split
of the ref rows (``split_plan``), the ring's depth within the block's
shared memory (``smem_bytes``, ``ring_stages``) and the workspace, and
mirrors the kernel's K walk over packed refs (``packed_k_walk``).
``plan=(rows per split, ring stages)`` overrides the first two (the
counterpart of the TPU kernel's ``tq``/``tn``/``td`` keywords, which
``tools/sweep_topk.py`` sweeps; the tiles here are the kernel's
compile-time constants); the result is the same under every plan.
``compute="int4"`` is accepted and computed as int8 (Hopper has no int4
mma): the result is the same.  ``l2_topk_rf`` takes the plain version for
CPU tensors only; a CUDA tensor goes to the kernel, or the wrapper raises
on what the kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build
from .planar import PACKS, planar_unpack

MAX_K = 128
MAX_WIDTH = 8192      # unpacked bytes: distances stay below 2^29 (the kernel's
                      # selection leans on it, csrc/l2_topk_rf.cu kThrCap)
_BQ = 128             # queries per pass-1 block (csrc/l2_topk_rf.cu kBQ)
_BN = 192             # ref rows per tile (kBN)
_KD = 128             # unpacked bytes of d per chunk (kKD)
_MAX_STAGES = 4       # ring stages at most (kMaxStages)
_SMEM_MAX = 232448    # dynamic shared memory a block may use on an H100
_PLAIN_CHUNK = 65536  # ref rows per step of the plain version
_SIGNATURES = {"l2_topk_rf_s8": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
               + [ctypes.c_void_p],
               "l2_topk_rf_smem": [ctypes.c_int] * 3}


def _unpacked(refs: torch.Tensor, pack: int) -> torch.Tensor:
    return refs if pack == 1 else planar_unpack(refs, pack,
                                                refs.shape[1] * pack)


def l2_topk_rf_plain(queries: torch.Tensor, refs: torch.Tensor,
                     r_norms: torch.Tensor, k: int, pack: int = 1
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in float64 (exact for these integers): the refs'
    planes unpacked, ``|q|^2 + trunc(r_norm) - 2 q.r`` a chunk of
    ``_PLAIN_CHUNK`` rows at a time, and a stable sort of the running best
    ``k`` with each chunk (the ``l2_ref.topk_smallest`` tie rule).  Takes
    any integer dtype."""
    r = _unpacked(refs, pack)
    q = queries.to(torch.float64)
    q = F.pad(q, (0, r.shape[1] - q.shape[1]))
    qn = (q * q).sum(dim=1)
    rn = r_norms.to(torch.float64)
    rn = torch.where(torch.isinf(rn), rn, torch.trunc(rn))
    b, n = q.shape[0], r.shape[0]
    best_v = q.new_empty(b, 0)
    best_i = torch.empty(b, 0, dtype=torch.long, device=q.device)
    for s in range(0, n, _PLAIN_CHUNK):
        e = min(s + _PLAIN_CHUNK, n)
        dist = qn[:, None] + rn[None, s:e] - 2.0 * (q @ r[s:e].to(
            torch.float64).T)
        ids = torch.arange(s, e, device=q.device).expand(b, e - s)
        vals, order = torch.sort(torch.cat([best_v, dist], dim=1), dim=1,
                                 stable=True)
        best_v = vals[:, :k]
        best_i = torch.gather(torch.cat([best_i, ids], dim=1), 1,
                              order[:, :k])
    if best_v.shape[1] < k:                 # fewer rows than k
        pad = k - best_v.shape[1]
        best_v = F.pad(best_v, (0, pad), value=float("inf"))
        best_i = F.pad(best_i, (0, pad), value=-1)
    return best_v.to(torch.float32), best_i.to(torch.int32)


def unpacked_width(d: int, refs_width: int, pack: int) -> int:
    """The width the kernel computes over: ``d`` rounded up to 128 bytes
    (pack 1), or the planar-packed rows' unpacked width."""
    return -(-max(d, 1) // _KD) * _KD if pack == 1 else refs_width * pack


def row_classes(refs_width: int, n: int, pack: int, base_aligned: bool
                ) -> int:
    """F, the row classes of pack 1 refs: TMA needs rows of a 16-byte
    stride, which ``[N / F, F * width]`` has for F = 16 / gcd(width, 16);
    a box of that view holds the rows ``c, c + F, ...`` of one class, and a
    pass-1 block searches one class.  1 when the rows need no such view, or
    cannot have it (packed refs, a base off 16 bytes, F not dividing N):
    those go through the kernel's cp.async loader."""
    if pack != 1 or not base_aligned:
        return 1
    f = 16 // math.gcd(refs_width, 16)
    return f if n % f == 0 else 1


def split_plan(b: int, n: int, sm_count: int, classes: int = 1
               ) -> tuple[int, int]:
    """(splits, rows per split) of the ref rows for pass 1.  A split is a
    range of one class's rows (``classes`` = 1: of all rows), a whole
    number of 192-row tiles; ``splits`` = ranges * classes, range-major, as
    many as keep the grid within one wave of one block per SM (long splits:
    a row's list changes about k (1 + ln(rows / k)) times a split)."""
    n_tiles = -(-(n // classes) // _BN)
    q_tiles = -(-b // _BQ)
    ranges = max(1, min(n_tiles, sm_count // (q_tiles * classes)))
    rows = -(-n_tiles // ranges) * _BN
    return plan_splits(n, classes, rows), rows


def smem_bytes(kp: int, packed: bool, stages: int) -> int:
    """Shared memory of one pass-1 block: the twin of ``Layout`` in
    ``csrc/l2_topk_rf.cu`` (``l2_topk_rf_smem``).  The ring's stages (128
    queries + 192 ref rows x 128 bytes), the packed staging panel, the 128
    rows' sorted lists (distances and ids, ``kp`` entries each:
    ``list_stride``), two tiles' norm codes, |q|^2, the mbarriers, and the
    slack to align to the 1024-byte swizzle period."""
    stage = (_BQ + _BN) * _KD
    lists = 2 * _BQ * kp * 4
    return (stages * stage + (_BN * _KD if packed else 0) + lists
            + 2 * _BN * 4 + _BQ * 4
            + (2 * _MAX_STAGES + 5) * 8 + 1024)


def list_stride(k: int) -> int:
    """``kp``: the entries a row's list is laid out with, 16 for k <= 16,
    else k rounded up to 32."""
    return 16 if k <= 16 else -(-k // 32) * 32


def ring_stages(kp: int, packed: bool) -> int:
    """The deepest ring that fits the block's shared memory (0: none)."""
    return max((s for s in range(1, _MAX_STAGES + 1)
                if smem_bytes(kp, packed, s) <= _SMEM_MAX), default=0)


def packed_k_walk(d: int, refs_width: int, pack: int) -> list[tuple[int, int, int]]:
    """The kernel's K loop as ``(column block, plane, first unpacked
    column)`` in order: 128-byte column blocks of the stored rows, each
    with its planes (pack 1: one); plane ``m`` of stored byte ``j`` is
    unpacked column ``m * refs_width + j``.  Chunks whose columns all lie
    at or past ``d`` (zero queries) are skipped."""
    blocks = refs_width // _KD if pack > 1 else -(-max(d, 1) // _KD)
    walk = [(cb, m, m * refs_width * (pack > 1) + cb * _KD)
            for cb in range(blocks) for m in range(pack)]
    return [(cb, m, u0) for cb, m, u0 in walk if u0 < max(d, 1)]


def check_plan(plan: tuple[int, int] | None, k: int, pack: int) -> None:
    """Raise ``ValueError`` unless ``plan`` is None or ``(rows, stages)``
    with ``rows`` a positive multiple of 192 and ``stages`` in
    ``1 ... ring_stages``."""
    if plan is None:
        return
    try:
        rows, stages = plan
    except (TypeError, ValueError):
        raise ValueError(f"l2_topk_rf: plan must be (rows per split, ring "
                         f"stages), got {plan!r}") from None
    deepest = ring_stages(list_stride(k), pack > 1)
    for name, x in (("rows", rows), ("stages", stages)):
        if isinstance(x, bool) or not isinstance(x, int):
            raise ValueError(f"l2_topk_rf: plan {name} must be an int, got "
                             f"{x!r}")
    if rows <= 0 or rows % _BN:
        raise ValueError(f"l2_topk_rf: plan rows must be a positive "
                         f"multiple of {_BN}, got {rows}")
    if not 1 <= stages <= deepest:
        raise ValueError(f"l2_topk_rf: plan stages must lie in 1 ... "
                         f"{deepest}, got {stages}")


def plan_splits(n: int, classes: int, rows: int) -> int:
    """The splits of ``rows`` rows of one class each that cover ``n``
    rows of ``classes`` classes (range-major, as ``split_plan``'s)."""
    return -(-(n // classes) // rows) * classes


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(queries, refs, r_norms, k, pack, compute) -> None:
    if pack not in (1,) + PACKS:
        raise ValueError(f"l2_topk_rf: pack must be 1, 2, 4 or 8, got {pack}")
    if compute not in (None, "int8", "int4"):
        raise ValueError(f"l2_topk_rf: compute must be None, 'int8' or "
                         f"'int4', got {compute!r}")
    if pack == 2 and compute == "int4":
        raise ValueError(
            "compute=int4 admits values in [-8, 7]: pack=2 planes reach 15 "
            "and doubled queries 30 -- use pack >= 4")
    if queries.dim() != 2 or refs.dim() != 2:
        raise ValueError(f"l2_topk_rf: need q [B, d] and refs [N, d], got "
                         f"{tuple(queries.shape)}, {tuple(refs.shape)}")
    for name, x in (("queries", queries), ("refs", refs)):
        if x.dtype != torch.int8:
            raise ValueError(f"l2_topk_rf: {name} must be int8, got "
                             f"{x.dtype}")
    d, (n, rw) = queries.shape[1], refs.shape
    if pack == 1 and d != rw:
        raise ValueError(f"l2_topk_rf: queries d={d} != refs d={rw}")
    if pack > 1 and (rw % _KD or d > rw * pack):
        raise ValueError(f"l2_topk_rf: packed refs need a width that is a "
                         f"multiple of {_KD} (pack_planar's) and d <= "
                         f"width * pack, got width {rw}, d={d}, pack {pack}")
    if r_norms.shape != (n,) or r_norms.dtype != torch.float32:
        raise ValueError("l2_topk_rf: r_norms must be float32 [N]")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"l2_topk_rf: k={k} outside [1, {MAX_K}]")


def l2_topk_rf(queries: torch.Tensor, refs: torch.Tensor,
               r_norms: torch.Tensor, k: int, pack: int = 1,
               compute: str | None = None,
               plan: tuple[int, int] | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of ``refs`` for each int8 query by exact squared L2
    (see the module docstring).  On the card the unpacked width may reach
    ``MAX_WIDTH`` bytes, within which int32 distances cannot overflow;
    finite norms are the rows' squared norms (below 2^28 there).
    ``plan``: ``(rows per split, ring stages)`` in place of ``split_plan``
    and ``ring_stages``' choice (checked on every device; the plain version
    has no plan)."""
    _check(queries, refs, r_norms, k, pack, compute)
    check_plan(plan, k, pack)
    if queries.device.type == "cpu":
        return l2_topk_rf_plain(queries, refs, r_norms, k, pack)
    if queries.device.type != "cuda":
        raise ValueError(f"l2_topk_rf: unsupported device {queries.device}")
    for name, x in (("refs", refs), ("r_norms", r_norms)):
        if x.device != queries.device:
            raise ValueError(f"l2_topk_rf: {name} is not on {queries.device}")
    for name, x in (("queries", queries), ("refs", refs),
                    ("r_norms", r_norms)):
        if not x.is_contiguous():
            raise ValueError(f"l2_topk_rf: {name} must be contiguous")
    b, d = queries.shape
    n, rw = refs.shape
    dp = unpacked_width(d, rw, pack)
    if dp > MAX_WIDTH:
        raise ValueError(f"l2_topk_rf: unpacked width {dp} > {MAX_WIDTH}: "
                         "int32 distances could overflow")
    kp = list_stride(k)
    stages = ring_stages(kp, pack > 1)
    lib = _build.load("l2_topk_rf", _SIGNATURES)
    vals = torch.empty(b, k, dtype=torch.float32, device=queries.device)
    ids = torch.empty(b, k, dtype=torch.int32, device=queries.device)
    if b == 0:
        return vals, ids
    index = queries.device.index
    sms = _sm_count(torch.cuda.current_device() if index is None else index)
    classes = row_classes(rw, n, pack, refs.data_ptr() % 16 == 0) if n else 1
    if plan is None:
        splits, rows = split_plan(b, max(n, 1), sms, classes)
    else:
        rows, stages = plan
        splits = plan_splits(max(n, 1), classes, rows)
    # the splits' lists (distances, then ids), then the queries copied to
    # rows of 16-byte stride where theirs are not
    lists = -(-8 * splits * b * k // 256) * 256
    if classes > 1:      # a copy per row class, shifted by up to 15 bytes
        padded = classes * b * -(-(d + 15) // 16) * 16
    elif d % 16 == 0 and queries.data_ptr() % 16 == 0:
        padded = 0
    else:
        padded = b * -(-d // 16) * 16
    ws = torch.empty(lists + padded, dtype=torch.uint8, device=queries.device)
    with torch.cuda.device(queries.device):
        rc = lib.l2_topk_rf_s8(
            queries.data_ptr(), refs.data_ptr(), r_norms.data_ptr(),
            ws.data_ptr(), vals.data_ptr(), ids.data_ptr(), b, n, d, rw, pack,
            classes, k, kp, splits, rows, stages,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "l2_topk_rf")
    l2_topk_rf.launches += 1
    return vals, ids


l2_topk_rf.launches = 0
