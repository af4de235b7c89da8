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
for), bf16 products are exact with float32 sums.  Pass 1 is a
warp-specialized TMA/mbarrier ring feeding wgmma products, with the
selection as the products' epilogue; in float32 a pre-pass splits each
value into its TF32 parts once a call (the refs a batch of rows at a time,
``_SPLIT_BYTES`` of parts at most).  The wrapper
pads d with zero columns to a multiple of 8 (16-byte rows, what TMA takes)
where it must, plans the batches and the split of their rows
(``batch_plan``, ``split_plan``) and the ring's depth within the block's
shared memory (``smem_bytes``, ``block_config``), and owns the workspace.
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
_BN = 128             # ref rows per tile (kBN)
_PANEL = 128 * 128    # bytes of one swizzled panel: 128 rows x 128 bytes
_MAX_STAGES = 4       # ring stages at most (kMaxStages)
_SMEM_MAX = 232448    # dynamic shared memory a block may use on an H100
_SPLIT_BYTES = 1 << 30  # float32: the refs' TF32 parts of one batch of rows
_PLAIN_CHUNK = 65536  # ref rows per step of the plain version
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"l2_topk_float_prep": [_P] * 4 + [_I] * 3 + [_P],
               "l2_topk_float_split": [_P] * 3 + [ctypes.c_longlong, _P],
               "l2_topk_float_pass1": [_P] * 8 + [_I] * 10 + [_P],
               "l2_topk_float_merge": [_P] * 4 + [_I] * 3 + [_P],
               "l2_topk_float_smem": [_I] * 2}


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


def list_stride(k: int) -> int:
    """``kp``: the entries a row's list is laid out with, 16 for k <= 16,
    else k rounded up to 32."""
    return 16 if k <= 16 else -(-k // 32) * 32


def smem_bytes(kp: int, stages: int) -> int:
    """Shared memory of one pass-1 block: the twin of ``Layout`` in
    ``csrc/l2_topk_float.cu`` (``l2_topk_float_smem``).  The ring's stages
    of four panels of 128 rows x 128 bytes (bf16: two chunks of d of the
    queries and of the ref rows; float32: one, of their TF32 hi and lo
    parts), the 128 rows' sorted lists (distances and ids, ``kp`` entries
    each), the two consumers' tile norms, the mbarriers, and the slack to
    align to the 1024-byte swizzle period."""
    return (stages * 4 * _PANEL + 2 * _BQ * kp * 4 + 2 * _BN * 4
            + 2 * _MAX_STAGES * 8 + 1024)


def ring_stages(kp: int) -> int:
    """The deepest ring that fits the block's shared memory."""
    return max(s for s in range(1, _MAX_STAGES + 1)
               if smem_bytes(kp, s) <= _SMEM_MAX)


def block_config(k: int) -> tuple[int, int]:
    """``(kp, stages)`` of pass 1, the arguments of ``l2_topk_float_smem``:
    k <= 16 takes 16-entry lists, else k rounded up to 32; the ring of
    64 KB stages shrinks as the lists grow, from 3 stages at k <= 32 to 1
    at k > 96."""
    kp = list_stride(k)
    return kp, ring_stages(kp)


def split_plan(b: int, n: int, sm_count: int) -> tuple[int, int]:
    """(splits, rows per split) of ``n`` ref rows for pass 1: whole tiles of
    128 rows, as many splits as keep the grid (query tiles x splits) within
    one wave of one block an SM (long splits: a row's list changes about
    k (1 + ln(rows / k)) times a split)."""
    n_tiles = max(1, -(-n // _BN))
    q_tiles = -(-b // _BQ)
    want = max(1, min(n_tiles, sm_count // q_tiles))
    rows = -(-n_tiles // want) * _BN
    return max(1, -(-n // rows)), rows


def batch_plan(b: int, n: int, width: int, bf16: bool, sm_count: int
               ) -> list[tuple[int, int, int, int]]:
    """``[(first row, rows, splits, rows per split)]``: the batches of ref
    rows that pass 1 takes one launch each, in id order.  bf16 takes all
    rows at once; float32 takes as many as keep their TF32 hi and lo parts
    (a workspace of 2 x rows x width floats, made once a batch) within
    ``_SPLIT_BYTES``.  No batch for N = 0."""
    step = (max(n, 1) if bf16
            else max(_BN, _SPLIT_BYTES // (8 * width) // _BN * _BN))
    return [(r0, min(step, n - r0), *split_plan(b, min(step, n - r0),
                                                 sm_count))
            for r0 in range(0, n, step)]


def padded_width(d: int) -> int:
    """The width the kernel reads: d rounded up to 8 columns, so that every
    row starts on 16 bytes in both dtypes (TMA's row stride is a multiple
    of 16 bytes; columns past d are zeros)."""
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
    dev = queries.device
    vals = torch.empty(b, k, dtype=torch.float32, device=dev)
    ids = torch.empty(b, k, dtype=torch.int32, device=dev)
    if b == 0:
        return vals, ids
    dp = padded_width(d)
    q = _padded(queries.to(refs.dtype), dp)
    r = _padded(refs, dp)
    bf16 = refs.dtype == torch.bfloat16
    kp, stages = block_config(k)
    sms = _sm_count(torch.cuda.current_device() if dev.index is None
                    else dev.index)
    plan = batch_plan(b, n, dp, bf16, sms)
    splits = sum(p[2] for p in plan)
    if splits == 1:                     # pass 1 writes the answer
        part_v, part_i = vals, ids
    else:
        part_v = torch.empty(splits, b, k, dtype=torch.float32, device=dev)
        part_i = torch.empty(splits, b, k, dtype=torch.int32, device=dev)
    qn = torch.empty(b, dtype=torch.float64, device=dev)
    q_hi = q_lo = r_hi = r_lo = None
    if not bf16:                        # the TF32 parts
        q_hi, q_lo = torch.empty_like(q), torch.empty_like(q)
        if plan:
            r_hi, r_lo = torch.empty(2, plan[0][1], dp, dtype=torch.float32,
                                     device=dev)
    ptr = (lambda x: None if x is None else x.data_ptr())
    lib = _build.load("l2_topk_float", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.l2_topk_float_prep(
            q.data_ptr(), qn.data_ptr(), ptr(q_hi), ptr(q_lo), b, dp,
            int(bf16), stream), "l2_topk_float")
        s0 = 0
        for row0, rows, n_splits, per in plan:
            rb = r[row0:row0 + rows]
            if not bf16:
                _build.check(lib.l2_topk_float_split(
                    rb.data_ptr(), r_hi.data_ptr(), r_lo.data_ptr(),
                    rows * dp, stream), "l2_topk_float")
                rb = r_hi
            _build.check(lib.l2_topk_float_pass1(
                ptr(q if bf16 else q_hi), ptr(q_lo), qn.data_ptr(),
                rb.data_ptr(), ptr(r_lo), r_norms[row0:].data_ptr(),
                part_v[s0].data_ptr(),
                part_i[s0].data_ptr(), b, rows, dp, k, kp, int(bf16),
                n_splits, per, stages, row0, stream), "l2_topk_float")
            s0 += n_splits
        if splits != 1:
            _build.check(lib.l2_topk_float_merge(
                part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
                ids.data_ptr(), b, k, splits, stream), "l2_topk_float")
    l2_topk_float.launches += 1
    return vals, ids


l2_topk_float.launches = 0
