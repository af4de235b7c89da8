"""Window contexts and exact L2 search.

Embedding space (V18): the window's reference haplotypes, masked at the
window's masked sites, are embedded by the model's embedding in eval mode;
the search operand is that embedding stored in bfloat16, as the model
family defines its index, and a query is its own embedding rounded the
same way.  Token space (V17): the masked token ids themselves.  The
distance is the squared L2 distance computed in float64 (exact for token
ids); the nearest row wins, ties to the lower row; rows past the panel
never win."""

from __future__ import annotations

import torch

from .data import MASK

CHUNK = 256


def masked(tokens: torch.Tensor, window_mask: torch.Tensor) -> torch.Tensor:
    return torch.where(window_mask.bool()[None, :],
                       torch.full_like(tokens, MASK), tokens)


@torch.no_grad()
def embedding_context(model, ref_tokens, window_mask, af, valid):
    """``(search operand [N, L * D] float64 of the bf16 embedding, ref
    tokens, af, valid)``."""
    was = model.training
    model.eval()
    try:
        m = masked(ref_tokens, window_mask)
        rows = []
        for i in range(0, m.shape[0], CHUNK):
            part = m[i: i + CHUNK]
            e = model.embed(part, af[None].expand(part.shape[0], -1))
            rows.append(e.to(torch.bfloat16).reshape(part.shape[0], -1))
        return torch.cat(rows), ref_tokens, af, valid
    finally:
        model.train(was)


def nearest(queries: torch.Tensor, refs: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """Index of each query's nearest valid row (float64 squared L2,
    ties to the lower row), refs taken ``CHUNK`` rows at a time."""
    q = queries.double()
    best_d = torch.full((q.shape[0],), float("inf"), dtype=torch.float64,
                        device=q.device)
    best_i = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    qn = (q * q).sum(1)
    for i in range(0, refs.shape[0], CHUNK):
        r = refs[i: i + CHUNK].double()
        d = qn[:, None] - 2.0 * (q @ r.T) + (r * r).sum(1)[None, :]
        d = torch.where(valid[i: i + CHUNK][None, :], d,
                        torch.full_like(d, float("inf")))
        v, j = d.min(1)        # the first minimum: the lower row
        better = v < best_d
        best_d = torch.where(better, v, best_d)
        best_i = torch.where(better, j + i, best_i)
    return best_i


def retrieve_embedding(model, batch: dict, ctx) -> dict:
    """The batch plus ``query_emb`` ``[2B, L, D]`` and ``rag_emb_h1/h2``
    ``[B, 1, L, D]`` (rag_k 1): the queries' embeddings, the nearest
    reference's complete tokens re-embedded."""
    search, ref_tokens, af, valid = ctx
    b = batch["hap_1"].shape[0]
    toks = torch.cat([batch["hap_1"], batch["hap_2"]], 0)
    af2 = torch.cat([batch["af"], batch["af"]], 0)
    q = model.embed(toks, af2)
    ids = nearest(q.detach().to(torch.bfloat16).reshape(2 * b, -1), search,
                  valid)
    ret = model.embed(ref_tokens[ids], af[None].expand(2 * b, -1))
    out = dict(batch)
    out["query_emb"] = q
    out["rag_emb_h1"], out["rag_emb_h2"] = (x[:, None] for x in
                                            ret.chunk(2, 0))
    return out


def retrieve_tokens(batch: dict, ref_tokens, window_mask, valid) -> dict:
    """The batch plus ``rag_seg_h1/h2`` ``[B, 1, L]``: the complete tokens
    of each haplotype's nearest masked reference."""
    q = torch.cat([batch["hap_1"], batch["hap_2"]], 0)
    ids = nearest(q, masked(ref_tokens, window_mask), valid)
    i1, i2 = ids.chunk(2, 0)
    out = dict(batch)
    out["rag_seg_h1"] = ref_tokens[i1][:, None]
    out["rag_seg_h2"] = ref_tokens[i2][:, None]
    return out
