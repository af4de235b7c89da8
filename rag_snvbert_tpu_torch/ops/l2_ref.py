"""Plain reference implementations of exact squared-L2 k-NN search.

Port of rag_snvbert_tpu/ops/l2_ref.py:25-73.  Ties rank by ascending row
id: ``torch.topk`` promises no tie order, so selection is a stable sort.
"""

from __future__ import annotations

import torch


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms, computed in float32."""
    xf = x.float()
    return (xf * xf).sum(dim=-1)


def l2_distances(queries: torch.Tensor, refs: torch.Tensor,
                 q_norms: torch.Tensor | None = None,
                 r_norms: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise squared distances ``[B, N]`` via ``|q|^2 - 2 q.r + |r|^2``
    in float32 (one float32 matmul; TF32 must be off on the card)."""
    if q_norms is None:
        q_norms = squared_norms(queries)
    if r_norms is None:
        r_norms = squared_norms(refs)
    dots = torch.matmul(queries.float(), refs.float().T)
    return (q_norms[:, None] - 2.0 * dots + r_norms[None, :]).clamp_min(0.0)


def topk_smallest(dists: torch.Tensor,
                  k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row -> (values [B, k], int32 ids [B, k]), ascending,
    ties to the lower id."""
    vals, ids = torch.sort(dists, dim=1, stable=True)
    return vals[:, :k], ids[:, :k].to(torch.int32)


def l2_topk(queries: torch.Tensor, refs: torch.Tensor, k: int,
            r_norms: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by squared L2 (the oracle)."""
    return topk_smallest(l2_distances(queries, refs, r_norms=r_norms), k)
