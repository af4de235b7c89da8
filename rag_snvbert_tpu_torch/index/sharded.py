"""Row-sharded flat L2 index: a search per shard, then an exact merge of the
shards' candidates.

Port of rag_snvbert_tpu/index/sharded.py (:33-188).  The rows of the
reference panel are split over the mesh's ``index`` axis: rank ``s`` of an
``index`` group holds rows ``[s * per, (s + 1) * per)`` of the panel padded
to ``per * n_shards`` rows (padding rows carry +inf norms and are never
retrieved ahead of a real row).  A search runs on every rank of the group
with the same queries: each searches its shard with the kernel
``FlatL2Index.search`` launches for the shard's storage and row count
(``l2_topk``, ``l2_topk_float`` or ``l2_topk_rf``; the streaming scan above
``MAX_K``), offsets its ids by ``s * per``, and the ``[B, k]`` candidate
sets merge exactly within the group:

  - ``"all_gather"``: one gather of ``[S, B, k]``, one merge of ``S * k``;
  - ``"ring"``: ``S - 1`` neighbour exchanges, ``[B, 2k]`` at most.

Ties go to the lower global id (``ops/l2_ref.merge_topk_smallest``), as in
every search of the port.  A shard of fewer than ``k`` rows searches its
rows and pads its candidates with ``(+inf, -1)`` (the JAX package pads with
``(+inf, 0)``): only ids >= 0 are offset, so filler never names a real row.
On the card every shard launches its kernel (``use_pallas=None``): the
plain version runs only on CPU tensors, or when ``use_pallas=False`` asks
for it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..ops import l2_ref
from ..parallel import comm
from ..parallel.mesh import INDEX_AXIS, axis_group, axis_rank, axis_size
from .flat import FlatL2Index

MERGES = ("all_gather", "ring")

SearchFn = Callable[[torch.Tensor, int], tuple[torch.Tensor, torch.Tensor]]


def _local_topk(search: SearchFn, queries: torch.Tensor, rows: int, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``search(queries, k)`` over a shard of ``rows`` rows, with ``k``
    clamped to the rows and the candidates padded back to ``[B, k]`` with
    ``(+inf, -1)``."""
    k_local = min(k, rows)
    vals, ids = search(queries, k_local)
    if k_local < k:
        b = queries.shape[0]
        vals = torch.cat([vals, vals.new_full((b, k - k_local),
                                              float("inf"))], dim=1)
        ids = torch.cat([ids, ids.new_full((b, k - k_local), -1)], dim=1)
    return vals, ids


def _global_ids(ids: torch.Tensor, shard: int, rows_per_shard: int
                ) -> torch.Tensor:
    """Shard-local ids -> global ids (int64); the -1 filler stays -1."""
    ids = ids.long()
    return torch.where(ids >= 0, ids + shard * rows_per_shard, ids)


def _ring_merge(vals: torch.Tensor, gids: torch.Tensor, k: int, group
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``S - 1`` exchanges of the running ``[B, k]`` set with the ring's
    neighbours, each merged into the best so far (JAX ``_ring_merge``)."""
    best_v, best_g, cur_v, cur_g = vals, gids, vals, gids
    for _ in range(torch.distributed.get_world_size(group) - 1):
        cur_v = comm.ring_shift(cur_v, group)
        cur_g = comm.ring_shift(cur_g, group)
        best_v, best_g = l2_ref.merge_topk_smallest(
            torch.cat([best_v, cur_v], dim=1),
            torch.cat([best_g, cur_g], dim=1), k)
    return best_v, best_g


def merge_shards(vals: torch.Tensor, gids: torch.Tensor, k: int, group,
                 merge: str = "all_gather"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k of every rank's ``[B, k]`` candidates in ``group``
    (global ids), the same on every rank."""
    if merge not in MERGES:
        raise ValueError(f"merge must be one of {MERGES}, got {merge!r}")
    if merge == "ring":
        return _ring_merge(vals, gids, k, group)
    all_v = comm.all_gather(vals, group)            # [S, B, k]
    all_g = comm.all_gather(gids, group)
    b = vals.shape[0]
    return l2_ref.merge_topk_smallest(
        all_v.transpose(0, 1).reshape(b, -1),
        all_g.transpose(0, 1).reshape(b, -1), k)


def sharded_search(search: SearchFn, queries: torch.Tensor, k: int,
                   rows_per_shard: int, shard: int, group,
                   merge: str = "all_gather"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank's part of a sharded search (JAX ``_sharded_search_body``):
    its shard's top-k, global ids, the merge within ``group``.  Returns
    float32 distances and int64 global ids ``[B, k]``."""
    vals, ids = _local_topk(search, queries, rows_per_shard, k)
    gids = _global_ids(ids, shard, rows_per_shard)
    return merge_shards(vals.float(), gids, k, group, merge)


class ShardedFlatL2Index:
    """Flat L2 index with its rows sharded over a mesh axis; ``local`` is
    this rank's shard (a ``FlatL2Index`` of ``rows_per_shard`` rows)."""

    def __init__(self, mesh, local: FlatL2Index, ntotal: int,
                 rows_per_shard: int, axis: str = INDEX_AXIS):
        self.mesh = mesh
        self.axis = axis
        self.local = local
        self.ntotal = ntotal
        self.rows_per_shard = rows_per_shard

    @classmethod
    def build(cls, mesh, vectors, axis: str = INDEX_AXIS,
              dtype=torch.float32, pack: int = 1, device=None
              ) -> "ShardedFlatL2Index":
        """``vectors [N, d]`` (the whole panel, numpy or torch, on every
        rank); this rank keeps its shard, stored as ``dtype`` or
        planar-packed (``pack > 1``) on ``device`` (``None``: the card)."""
        device = resolve_device(device)
        v = vectors if isinstance(vectors, torch.Tensor) \
            else torch.from_numpy(np.asarray(vectors))
        n, d = v.shape
        if pack > 1:
            # checked over the whole panel on every rank, so a shard
            # without the offending value does not go on alone
            hi = 1 << (8 // pack)
            lo_v, hi_v = (int(x) for x in torch.aminmax(v))
            if lo_v < 0 or hi_v >= hi:
                raise ValueError(f"pack={pack} admits values in [0, {hi})")
        per = -(-n // axis_size(mesh, axis))     # padded to equal shards
        lo = axis_rank(mesh, axis) * per
        end = lo + per
        rows = v[lo: min(end, n)]
        if rows.shape[0] < per:
            rows = torch.cat([rows, rows.new_zeros(per - rows.shape[0], d)])
        if pack > 1:
            local = FlatL2Index.build(rows.to(torch.int8), pack=pack,
                                      device=device)
        else:
            local = FlatL2Index.build(rows, dtype=dtype, device=device)
        n_mine = max(0, min(end, n) - lo)
        local.norms[n_mine:] = float("inf")
        return cls(mesh, local, ntotal=n, rows_per_shard=per, axis=axis)

    def search(self, queries, k: int, use_pallas: bool | None = None,
               merge: str = "all_gather"
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """k-NN over every shard -> (float32 squared distances [B, k],
        int32 global ids [B, k]), ascending, ties to the lower id; the same
        on every rank of the ``index`` group.  ``merge``: "all_gather" or
        "ring".  ``use_pallas``: ``None`` launches each shard's kernel on
        the card (the plain version on the CPU), ``False`` the plain
        version."""
        q = queries if isinstance(queries, torch.Tensor) \
            else torch.from_numpy(np.asarray(queries))
        q = q.to(self.local.device)
        use = q.is_cuda if use_pallas is None else use_pallas

        def search(qs, kk):
            return self.local.search(qs, kk, use_pallas=use)

        vals, gids = sharded_search(
            search, q, k, self.rows_per_shard,
            axis_rank(self.mesh, self.axis),
            axis_group(self.mesh, self.axis), merge)
        return vals, gids.to(torch.int32)
