"""Exact squared-L2 top-k: wrapper of ``csrc/l2_topk.cu`` and its plain
version.

The kernel replaces rag_snvbert_tpu/ops/l2_topk_pallas.py::_l2_topk_kernel
(reached through ``l2_topk_pallas``), the embedding-space search of the
serving path.  It returns exact float32 distances with the ``l2_ref`` tie
rule (ascending id), where the TPU kernel quantizes distances to 2048 ULP.
Pass 1 is a TMA/mbarrier ring feeding wgmma products over a split of the d
axis; this module plans the split (``split_plan``) and owns the workspace.
``l2_topk`` takes the plain version for CPU tensors only; a CUDA tensor
goes to the kernel, or the wrapper raises on what the kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, l2_ref

MAX_K = 128
_STAGE_D = 128      # columns of d per pipeline stage (csrc/l2_topk.cu kStageD)
_TILE_B = 64        # queries per pass-1 block (kTileB)
_TILE_N = 128       # reference rows per pass-1 block (kTileN)
_WAVES = 4          # 16 ref tiles x 33 splits are four full waves of 132 SMs
_MAX_N = 49152      # pass 2 holds one float per reference row in shared memory
_SIGNATURES = {"l2_topk_bf16": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
               + [ctypes.c_void_p]}


def l2_topk_plain(queries: torch.Tensor, refs: torch.Tensor,
                  r_norms: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 matmul + stable sort over queries cast to ``refs.dtype``."""
    qf = queries.to(refs.dtype)
    d = l2_ref.l2_distances(qf, refs, r_norms=r_norms.float())
    return l2_ref.topk_smallest(d, k)


def split_plan(b: int, n: int, d: int, sm_count: int) -> tuple[int, int]:
    """(splits, chunk) of the d axis for pass 1: as many splits as fill
    ``_WAVES`` waves of one block per SM, each chunk a whole number of
    pipeline stages."""
    tiles = -(-n // _TILE_N) * -(-b // _TILE_B)
    steps = -(-d // _STAGE_D)
    want = max(1, min(steps, _WAVES * sm_count // tiles))
    chunk = -(-steps // want) * _STAGE_D
    return -(-d // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def l2_topk(queries: torch.Tensor, refs: torch.Tensor, r_norms: torch.Tensor,
            k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of ``refs [N, d]`` for each of ``queries [B, d]`` by
    squared L2 -> ``(vals [B, k] f32, ids [B, k] int32)``, ascending, ties
    to the lower id.  ``r_norms [N]`` are the rows' squared norms (+inf on
    rows never to be returned ahead of a finite one)."""
    if queries.device.type == "cpu":
        return l2_topk_plain(queries, refs, r_norms, k)
    if queries.device.type != "cuda":
        raise ValueError(f"l2_topk: unsupported device {queries.device}")
    if queries.dim() != 2 or refs.dim() != 2 or \
            queries.shape[1] != refs.shape[1]:
        raise ValueError(f"l2_topk: need q [B, d], refs [N, d], got "
                         f"{queries.shape}, {refs.shape}")
    b, d = queries.shape
    n = refs.shape[0]
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"l2_topk: k={k} outside [1, min({MAX_K}, N={n})]")
    if n > _MAX_N or d % 8:
        raise ValueError(f"l2_topk: need N <= {_MAX_N} and d % 8 == 0, got "
                         f"N={n}, d={d}")
    if r_norms.shape != (n,) or r_norms.dtype != torch.float32 or \
            not r_norms.is_contiguous():
        raise ValueError("l2_topk: r_norms must be contiguous float32 [N]")
    for name, x in (("queries", queries), ("refs", refs),
                    ("r_norms", r_norms)):
        if x.device != queries.device:
            raise ValueError(f"l2_topk: {name} is not on {queries.device}")
    for name, x in (("queries", queries), ("refs", refs)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"l2_topk: {name} must be bf16, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"l2_topk: {name} must be contiguous and "
                             "16-byte aligned")
    lib = _build.load("l2_topk", _SIGNATURES)
    index = queries.device.index
    sms = _sm_count(torch.cuda.current_device() if index is None else index)
    splits, chunk = split_plan(b, n, d, sms)
    # the partial dots [splits, b, n], then the partial |q|^2 [splits, b]
    part = torch.empty(splits * b * (n + 1), dtype=torch.float32,
                       device=queries.device)
    vals = torch.empty(b, k, dtype=torch.float32, device=queries.device)
    ids = torch.empty(b, k, dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        rc = lib.l2_topk_bf16(
            queries.data_ptr(), refs.data_ptr(), r_norms.data_ptr(),
            part.data_ptr(), vals.data_ptr(), ids.data_ptr(), b, n, d,
            splits, chunk, k, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "l2_topk")
    l2_topk.launches += 1
    return vals, ids


l2_topk.launches = 0
