"""In-training retrieval against a window context whose reference rows are
sharded over the mesh's ``index`` axis.

Port of rag_snvbert_tpu/train/sharded_retrieval.py (:42-182), the
scale-out path for panels whose masked-embedding matrix ``[N, L * D]``
exceeds one card:

  - the context is encoded shard-locally: each rank embeds only its own
    reference rows, with no collective;
  - the complete reference tokens ``[N_pad, L]`` stay replicated, so the
    gradient-bearing re-embedding of the retrieved rows is local;
  - the stacked ``[2B, L]`` query embedding keeps its gradient; the search
    (no gradient) runs per shard and the ``[2B, k]`` candidates merge
    exactly within the ``index`` group (``index/sharded.py``), by
    ``all_gather`` or a ring;
  - batches may at the same time be split over ``data``: each data rank
    searches its own queries against every index shard.

On the card every shard's search launches ``ops.l2_topk``, as the
single-process ``retrieve`` does (a 1,024-row shard of the 2,048-row
``tpu_default`` context; the JAX package runs its plain XLA search here,
sharded_retrieval.py:162-168).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..index.sharded import sharded_search
from ..ops.l2_topk import l2_topk, l2_topk_plain
from ..parallel.mesh import (INDEX_AXIS, axis_group, axis_rank,
                             axis_size, index_row_sharding)
from .retrieval import EmbedFn, encode_window_refs


@dataclasses.dataclass
class ShardedWindowRefContext:
    """Sharded search side + replicated result side of one window.

    ref_emb_search: [per, L, D] this rank's masked-reference embeddings.
    ref_norms:      [per] their float32 squared norms (+inf on padding).
    ref_tokens:     [N_pad, L] complete tokens of every row (replicated).
    ref_af:         [L] window AF.
    shard, rows_per_shard, group: this rank's shard, the shard size and
                    the ``index`` group the candidates merge in.
    """

    ref_emb_search: torch.Tensor
    ref_norms: torch.Tensor
    ref_tokens: torch.Tensor
    ref_af: torch.Tensor
    shard: int
    rows_per_shard: int
    group: object


@torch.no_grad()
def encode_window_refs_sharded(embed_fn: EmbedFn, ref_tokens: torch.Tensor,
                               ref_af: torch.Tensor,
                               window_mask: torch.Tensor, mesh,
                               valid: torch.Tensor | None = None,
                               dtype: torch.dtype = torch.bfloat16
                               ) -> ShardedWindowRefContext:
    """The sharded context of one window: ``ref_tokens`` ``[N, L]`` padded
    to ``per * n_shards`` rows, this rank's rows encoded as
    ``encode_window_refs`` does (padding rows +inf)."""
    n = ref_tokens.shape[0]
    lo, hi, per = index_row_sharding(mesh, n)
    n_pad = per * axis_size(mesh, INDEX_AXIS)
    toks = F.pad(ref_tokens, (0, 0, 0, n_pad - n))
    ok = torch.ones(n, dtype=torch.bool, device=ref_tokens.device) \
        if valid is None else valid.bool()
    ok = F.pad(ok, (0, n_pad - n), value=False)
    local = encode_window_refs(embed_fn, toks[lo:hi], ref_af, window_mask,
                               valid=ok[lo:hi], dtype=dtype)
    return ShardedWindowRefContext(
        ref_emb_search=local.ref_emb_search, ref_norms=local.ref_norms,
        ref_tokens=toks, ref_af=ref_af, shard=axis_rank(mesh, INDEX_AXIS),
        rows_per_shard=per, group=axis_group(mesh, INDEX_AXIS))


def retrieve_sharded(embed_fn: EmbedFn, batch: dict,
                     ctx: ShardedWindowRefContext, k: int = 1,
                     merge: str = "all_gather",
                     use_kernel: bool = True) -> dict:
    """``retrieve``'s contract against a sharded context: the batch plus
    ``rag_emb_h1/h2`` ``[B, k, L, D]`` and ``query_emb``, with gradient
    through the query embedding and the re-embedding."""
    af = batch["af"]
    b = batch["hap_1"].shape[0]
    toks = torch.cat([batch["hap_1"], batch["hap_2"]], dim=0)
    q = embed_fn(toks, torch.cat([af, af], dim=0))         # [2B, L, D]
    qf = q.detach().to(ctx.ref_emb_search.dtype).reshape(2 * b, -1)
    rf = ctx.ref_emb_search.reshape(ctx.rows_per_shard, -1)
    fn = l2_topk if use_kernel else l2_topk_plain

    def search(queries, kk):
        return fn(queries, rf, ctx.ref_norms, kk)

    _, ids = sharded_search(search, qf, k, ctx.rows_per_shard, ctx.shard,
                            ctx.group, merge)
    ret_tokens = ctx.ref_tokens[ids.reshape(-1)]              # [2Bk, L]
    ret_af = ctx.ref_af[None, :].expand_as(ret_tokens)
    ret_emb = embed_fn(ret_tokens, ret_af)
    l, d = ret_emb.shape[-2:]
    rag1, rag2 = ret_emb.chunk(2, dim=0)
    out = dict(batch)
    out["rag_emb_h1"] = rag1.reshape(b, k, l, d)
    out["rag_emb_h2"] = rag2.reshape(b, k, l, d)
    out["query_emb"] = q
    return out
