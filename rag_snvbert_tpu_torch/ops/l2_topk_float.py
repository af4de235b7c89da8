"""Exact squared-L2 top-k over float32 or bf16 vectors at any B, N and d:
wrapper of ``csrc/l2_topk_float.cu`` and its plain version.

The kernel replaces the float searches of
rag_snvbert_tpu/ops/l2_topk_pallas.py that ``ops.l2_topk`` does not take:
``_l2_topk_kernel`` with float32 inputs (the product at
``Precision.HIGHEST``) and the float branch of ``_l2_topk_kernel_rf``.  The
offline index (``index.flat.FlatL2Index``) reaches it for float32 storage,
and for bf16 storage beyond ``l2_topk``'s N <= 49,152.  Queries are cast to
the refs' dtype first (as ``l2_topk_pallas`` does); ``r_norms [N]`` are
float32 squared norms, ``+inf`` on rows never returned ahead of a finite
one.  Returns ``(vals [B, k] float32, ids [B, k] int32)``, ascending, ties
to the lower id.

Differences from the TPU kernel (README.md, port section), as for the
port's other two searches: distances are exact float32 values, not the
TPU's 2^(id_bits+1)-ULP sort keys; ``+inf`` rows rank after every finite
row in id order; slots past the last row hold ``(+inf, -1)``.  float32
products are three TF32 products a pair (what ``Precision.HIGHEST`` asks
for), bf16 products are exact with float32 sums.  The wrapper pads d with
zero columns to a multiple of 8 (16-byte rows) where it must, plans the
split of the ref rows (``split_plan``) and owns the workspace.
``l2_topk_float`` takes the plain version for CPU tensors only; a CUDA
tensor goes to the kernel, or the wrapper raises on what the kernel does
not take.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build, l2_ref

MAX_K = 128
DTYPES = (torch.float32, torch.bfloat16)
_BQ = 128             # queries per pass-1 block (csrc/l2_topk_float.cu kBQ)
_LD = 36              # words a staged row (kLd)
_PLAIN_CHUNK = 65536  # ref rows per step of the plain version
_SIGNATURES = {"l2_topk_float": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
               + [ctypes.c_void_p],
               "l2_topk_float_smem": [ctypes.c_int] * 3}


def l2_topk_float_plain(queries: torch.Tensor, refs: torch.Tensor,
                        r_norms: torch.Tensor, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function as the plain float32 expansion of ``l2_ref``:
    queries cast to ``refs.dtype``, ``|q|^2 - 2 q.r + |r|^2`` by a float32
    ``torch.matmul`` (TF32 must be off on the card) a chunk of
    ``_PLAIN_CHUNK`` rows at a time, and a stable sort of the running best
    ``k`` with each chunk (ties to the lower id).  Slots past N hold
    ``(+inf, -1)``."""
    q = queries.to(refs.dtype).float()
    qn = l2_ref.squared_norms(q)
    rn = r_norms.float()
    b, n = q.shape[0], refs.shape[0]
    best_v = q.new_empty(b, 0)
    best_i = torch.empty(b, 0, dtype=torch.long, device=q.device)
    for s in range(0, n, _PLAIN_CHUNK):
        e = min(s + _PLAIN_CHUNK, n)
        dist = l2_ref.l2_distances(q, refs[s:e], q_norms=qn, r_norms=rn[s:e])
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
    return best_v, best_i.to(torch.int32)


def block_config(k: int) -> tuple[int, int, int]:
    """``(bn, stages, kp)`` of pass 1: ref rows a tile, ring stages and the
    entries a list is laid out with.  k <= 32: 128-row tiles, three stages,
    32-entry lists; else 64-row tiles, two stages, k rounded up to 32."""
    if k <= 32:
        return 128, 3, 32
    return 64, 2, -(-k // 32) * 32


def smem_bytes(bn: int, stages: int, kp: int) -> int:
    """Shared memory of one pass-1 block: the twin of ``smem_bytes`` in
    ``csrc/l2_topk_float.cu`` (``l2_topk_float_smem``).  The ring (query
    and ref rows of 36 words each stage), the distance tile (rows of bn + 8
    floats), the 128 lists and |q|^2 (doubles)."""
    return (stages * (_BQ + bn) * _LD * 4 + _BQ * (bn + 8) * 4
            + _BQ * kp * 8 + _BQ * 8)


def split_plan(b: int, n: int, sm_count: int, bn: int) -> tuple[int, int]:
    """(splits, rows per split) of the ref rows for pass 1: whole tiles of
    ``bn`` rows, as many splits as keep the grid (query tiles x splits)
    within one wave of one block an SM."""
    n_tiles = max(1, -(-n // bn))
    q_tiles = -(-b // _BQ)
    want = max(1, min(n_tiles, sm_count // q_tiles))
    rows = -(-n_tiles // want) * bn
    return max(1, -(-n // rows)), rows


def padded_width(d: int) -> int:
    """The width the kernel reads: d rounded up to 8 columns, so that every
    row starts on 16 bytes in both dtypes."""
    return -(-max(d, 1) // 8) * 8


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(queries, refs, r_norms, k) -> None:
    if queries.dim() != 2 or refs.dim() != 2 or \
            queries.shape[1] != refs.shape[1]:
        raise ValueError(f"l2_topk_float: need q [B, d] and refs [N, d], "
                         f"got {tuple(queries.shape)}, {tuple(refs.shape)}")
    if refs.dtype not in DTYPES:
        raise ValueError(f"l2_topk_float: refs must be float32 or bf16, got "
                         f"{refs.dtype}")
    if not queries.dtype.is_floating_point:
        raise ValueError(f"l2_topk_float: queries must be floating point, "
                         f"got {queries.dtype}")
    if r_norms.shape != (refs.shape[0],) or r_norms.dtype != torch.float32:
        raise ValueError("l2_topk_float: r_norms must be float32 [N]")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"l2_topk_float: k={k} outside [1, {MAX_K}]")


def _padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` as it is where it is already ``width`` wide on a 16-byte base;
    else a copy with zero columns up to ``width``."""
    if x.shape[1] == width and x.data_ptr() % 16 == 0:
        return x
    out = x.new_zeros(x.shape[0], width)
    out[:, : x.shape[1]] = x
    return out


def l2_topk_float(queries: torch.Tensor, refs: torch.Tensor,
                  r_norms: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of float32 or bf16 ``refs [N, d]`` for each of
    ``queries [B, d]`` by exact squared L2 (see the module docstring)."""
    _check(queries, refs, r_norms, k)
    if queries.device.type == "cpu":
        return l2_topk_float_plain(queries, refs, r_norms, k)
    if queries.device.type != "cuda":
        raise ValueError(f"l2_topk_float: unsupported device "
                         f"{queries.device}")
    for name, x in (("refs", refs), ("r_norms", r_norms)):
        if x.device != queries.device:
            raise ValueError(f"l2_topk_float: {name} is not on "
                             f"{queries.device}")
    for name, x in (("queries", queries), ("refs", refs),
                    ("r_norms", r_norms)):
        if not x.is_contiguous():
            raise ValueError(f"l2_topk_float: {name} must be contiguous")
    b, d = queries.shape
    n = refs.shape[0]
    vals = torch.empty(b, k, dtype=torch.float32, device=queries.device)
    ids = torch.empty(b, k, dtype=torch.int32, device=queries.device)
    if b == 0:
        return vals, ids
    dp = padded_width(d)
    q = _padded(queries.to(refs.dtype), dp)
    r = _padded(refs, dp)
    bn, _, kp = block_config(k)
    index = queries.device.index
    sms = _sm_count(torch.cuda.current_device() if index is None else index)
    splits, rows = split_plan(b, n, sms, bn)
    if splits == 1:
        part_v, part_i = vals, ids
    else:
        part_v = torch.empty(splits, b, k, dtype=torch.float32,
                             device=queries.device)
        part_i = torch.empty(splits, b, k, dtype=torch.int32,
                             device=queries.device)
    lib = _build.load("l2_topk_float", _SIGNATURES)
    with torch.cuda.device(queries.device):
        rc = lib.l2_topk_float(
            q.data_ptr(), r.data_ptr(), r_norms.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(), b, n, dp, k,
            kp, bn, int(refs.dtype == torch.bfloat16), splits, rows,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "l2_topk_float")
    l2_topk_float.launches += 1
    return vals, ids


l2_topk_float.launches = 0
