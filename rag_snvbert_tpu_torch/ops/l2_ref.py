"""Plain reference implementations of exact squared-L2 and Hamming k-NN
search.

Port of rag_snvbert_tpu/ops/l2_ref.py.  Ties rank by ascending row id:
``torch.topk`` promises no tie order, so selection is a stable sort.  None
of these is a kernel; they are the oracles, the small-search paths of the
index and the streaming searches for k above the kernels' 128.

Hamming search works on LSB-first 32-bit words (``pack_bits``): bit i of
word w is element ``32 w + i``, the JAX package's uint32 layout.  PyTorch
has no general uint32 arithmetic or popcount, so the words are held in
int64 tensors (values below 2^32) and counted by a SWAR popcount;
``index.flat.HammingIndex.save`` writes them as uint32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


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


def merge_topk_smallest(cat_vals: torch.Tensor, cat_ids: torch.Tensor,
                        k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over concatenated (vals, ids) candidate sets with the
    ascending-id tie rule: a stable sort by id, then a stable sort by
    value."""
    order = torch.argsort(cat_ids, dim=1, stable=True)
    v1 = torch.gather(cat_vals, 1, order)
    g1 = torch.gather(cat_ids, 1, order)
    vals, pos = torch.sort(v1, dim=1, stable=True)
    return vals[:, :k], torch.gather(g1, 1, pos[:, :k])


def l2_topk_streaming(queries: torch.Tensor, refs: torch.Tensor, k: int,
                      r_norms: torch.Tensor | None = None,
                      chunk: int = 65536,
                      unpack: Callable[[torch.Tensor], torch.Tensor] | None
                      = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 k-NN for any k without a ``[B, N]`` matrix: the reference
    rows in ``chunk`` blocks (the last one zero-padded, its padding rows
    +inf), a running top-k merged per block.  ``unpack`` maps stored rows
    to the search domain per chunk (planar-packed int8 -> values); with it
    and no ``r_norms`` the norms are computed per chunk, so the unpacked
    matrix never exists whole.  Fewer than k rows leave ``(+inf, 0)``
    filler at the tail (JAX l2_ref.py:75-138)."""
    n = refs.shape[0]
    chunk = min(chunk, n)
    n_chunks = -(-n // chunk)
    norms_in_body = r_norms is None and unpack is not None
    if r_norms is None and not norms_in_body:
        r_norms = squared_norms(refs)
    qf = queries.float()
    q_norms = (qf * qf).sum(dim=-1)
    b, kc = qf.shape[0], min(k, chunk)
    best_v = torch.full((b, k), float("inf"), device=qf.device)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=qf.device)
    for c in range(n_chunks):
        base = c * chunk
        r_c = refs[base: base + chunk]
        short = chunk - r_c.shape[0]
        if short:
            r_c = F.pad(r_c, (0, 0, 0, short))
        rcf = (r_c if unpack is None else unpack(r_c)).float()
        valid = base + torch.arange(chunk, device=qf.device) < n
        if norms_in_body:
            rn_c = (rcf * rcf).sum(dim=-1)
        else:
            rn_c = F.pad(r_norms[base: base + chunk].float(), (0, short))
        rn_c = torch.where(valid, rn_c, torch.full_like(rn_c, float("inf")))
        d = l2_distances(qf, rcf, q_norms=q_norms, r_norms=rn_c)
        v, i = topk_smallest(d, kc)
        best_v, best_i = merge_topk_smallest(
            torch.cat([best_v, v], dim=1),
            torch.cat([best_i, i + base], dim=1), k)
    return best_v, best_i


def masked_l2_distances(queries: torch.Tensor, refs: torch.Tensor,
                        dim_mask: torch.Tensor) -> torch.Tensor:
    """Squared L2 over a subset of dimensions (``dim_mask [d]``, 1 = keep):
    ``|q.m|^2 - 2 (q.m) @ R^T + (R*R) @ m``, no index rebuild."""
    m = dim_mask.float()
    qm = queries.float() * m[None, :]
    rf = refs.float()
    q_norms = (qm * qm).sum(dim=-1)
    r_norms_m = torch.matmul(rf * rf, m)
    dots = torch.matmul(qm, rf.T)
    return (q_norms[:, None] - 2.0 * dots + r_norms_m[None, :]).clamp_min(0.0)


def masked_l2_topk(queries: torch.Tensor, refs: torch.Tensor,
                   dim_mask: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    return topk_smallest(masked_l2_distances(queries, refs, dim_mask), k)


# ---- Hamming search over bit-packed haplotypes ----

def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """0/1 ``[..., d]`` -> LSB-first 32-bit words ``[..., ceil(d / 32)]``,
    held as int64 (values below 2^32)."""
    d = x.shape[-1]
    xp = F.pad(x.to(torch.int64), (0, (-d) % 32))
    xp = xp.reshape(*x.shape[:-1], -1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    return (xp << shifts).sum(dim=-1)


def pack_bits_np(x: np.ndarray) -> np.ndarray:
    """Host-side ``pack_bits``: uint32 words, the same layout (for offline
    builds of large panels)."""
    d = x.shape[-1]
    pad = (-d) % 32
    xp = np.pad(np.asarray(x, np.uint8), [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    # np.packbits packs each byte; the little-endian uint32 view of four
    # packed bytes is the LSB-first 32-bit layout.
    words = np.packbits(xp.reshape(*x.shape[:-1], (d + pad) // 32, 4, 8),
                        axis=-1, bitorder="little")
    return words.reshape(*x.shape[:-1], -1).view("<u4").reshape(
        *x.shape[:-1], (d + pad) // 32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding a 32-bit value (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def hamming_distances(q_packed: torch.Tensor,
                      r_packed: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances ``[B, N]`` int32: XOR + popcount."""
    x = torch.bitwise_xor(q_packed[:, None, :], r_packed[None, :, :])
    return _popcount32(x).sum(dim=-1).to(torch.int32)


def hamming_topk(q_packed: torch.Tensor, r_packed: torch.Tensor,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    return topk_smallest(hamming_distances(q_packed, r_packed), k)


def hamming_topk_streaming(q_packed: torch.Tensor, r_packed: torch.Tensor,
                           k: int, valid: torch.Tensor | None = None,
                           chunk: int = 8192
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact Hamming k-NN without the ``[B, N, words]`` XOR tensor: the
    rows in ``chunk`` blocks, a running top-k merged per block; invalid and
    padding rows carry the int32 maximum.  The same results and tie rule as
    ``hamming_topk``."""
    b = q_packed.shape[0]
    n = r_packed.shape[0]
    sentinel = torch.iinfo(torch.int32).max
    chunk = min(chunk, n)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=r_packed.device)
    best_v = torch.full((b, k), sentinel, dtype=torch.int32,
                        device=q_packed.device)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=q_packed.device)
    for base in range(0, n, chunk):
        r_c = r_packed[base: base + chunk]
        v_c = valid[base: base + chunk]
        short = chunk - r_c.shape[0]
        if short:
            r_c = F.pad(r_c, (0, 0, 0, short))
            v_c = F.pad(v_c, (0, short), value=False)
        d = hamming_distances(q_packed, r_c)
        d = torch.where(v_c[None, :], d, torch.full_like(d, sentinel))
        v, i = topk_smallest(d, min(k, chunk))
        best_v, best_i = merge_topk_smallest(
            torch.cat([best_v, v], dim=1),
            torch.cat([best_i, i + base], dim=1), k)
    return best_v, best_i
