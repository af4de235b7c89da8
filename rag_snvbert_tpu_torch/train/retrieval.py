"""Retrieval, shared by training and serving: embedding space (V18) and
token space (V17).

Port of rag_snvbert_tpu/train/retrieval.py:39-236:
  1. ``encode_window_refs``: embed the window's *masked* reference
     haplotypes without gradient -> the per-window search context;
  2. ``retrieve``: embed the stacked ``[2B, L]`` queries, search the
     context by exact squared L2 (``ops.l2_topk``), re-embed the retrieved
     *complete* reference tokens into ``rag_emb_h1/h2``.
Plain differentiable torch: gradients flow through the query embedding and
the re-embedding; the search sees detached inputs.  Serving calls it under
``torch.inference_mode()``.

The token-space twins: ``build_token_window_ctx`` masks the window's
reference tokens and caches their norms (the per-window
``faiss.IndexFlatL2(1030)``), and ``retrieve_tokens`` searches the raw
masked token vectors (``ops.l2_topk_rf``, int8) and returns the *complete*
token segments ``rag_seg_h1/h2`` for ``BERTWithRAG`` to re-encode.  The
search is not differentiable (token ids), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from ..io.vocab import MASK
from ..ops import l2_ref
from ..ops.l2_topk import l2_topk, l2_topk_plain
from ..ops.l2_topk_rf import l2_topk_rf, l2_topk_rf_plain

EmbedFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# Reference rows embedded per step by encode_window_refs: bounds the float32
# temporaries of the embedding (~0.4 GB each at L = 1030, D = 384).
ENCODE_CHUNK = 256


@dataclasses.dataclass
class WindowRefContext:
    """Per-window retrieval state.

    ref_emb_search: [N, L, D] embeddings of *masked* refs (no gradient).
    ref_tokens:     [N, L] complete (unmasked) reference tokens.
    ref_af:         [L] window AF (shared by every reference haplotype).
    ref_norms:      [N] float32 squared norms of flattened ref_emb_search
                    (+inf for padding rows).
    """

    ref_emb_search: torch.Tensor
    ref_tokens: torch.Tensor
    ref_af: torch.Tensor
    ref_norms: torch.Tensor


def apply_token_mask(tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Overwrite masked positions (``mask`` [L], padded coords) with MASK."""
    return torch.where(mask.bool()[None, :],
                       torch.full_like(tokens, MASK), tokens)


@torch.no_grad()
def encode_window_refs(embed_fn: EmbedFn, ref_tokens: torch.Tensor,
                       ref_af: torch.Tensor, window_mask: torch.Tensor,
                       valid: torch.Tensor | None = None,
                       dtype: torch.dtype = torch.bfloat16
                       ) -> WindowRefContext:
    """Build the search context for one window.

    ``embed_fn(tokens [n, L], af [n, L]) -> [n, L, D]`` is the model's
    embedding layer in eval mode.  Rows are embedded ENCODE_CHUNK at a time
    into one preallocated ``dtype`` tensor: run whole at 2048 x 1030 x 384,
    the float32 temporaries of the embedding would take several GB.
    ``valid`` [N] bool gives padding rows +inf norms."""
    masked = apply_token_mask(ref_tokens, window_mask)
    n, l = masked.shape
    af_rows = ref_af[None, :].expand(min(ENCODE_CHUNK, n), l)
    emb = None
    norms = torch.empty(n, dtype=torch.float32, device=masked.device)
    for i in range(0, n, ENCODE_CHUNK):
        j = min(i + ENCODE_CHUNK, n)
        part = embed_fn(masked[i:j], af_rows[: j - i]).to(dtype)
        if emb is None:
            emb = torch.empty((n,) + part.shape[1:], dtype=dtype,
                              device=part.device)
        emb[i:j] = part
        norms[i:j] = l2_ref.squared_norms(part.reshape(j - i, -1))
    if valid is not None:
        norms = torch.where(valid, norms, torch.full_like(norms, float("inf")))
    return WindowRefContext(ref_emb_search=emb, ref_tokens=ref_tokens,
                            ref_af=ref_af, ref_norms=norms)


def search(q_emb: torch.Tensor, ctx: WindowRefContext, k: int,
           use_kernel: bool = True) -> torch.Tensor:
    """Top-k ids ``[B, k]`` (int64) for queries ``[B, L, D]``: the queries
    are cast to the context dtype (bf16) before norms and distances, as in
    the JAX package (retrieval.py:184).  ``use_kernel=False`` takes the
    plain version even on the card (the twin of ``use_pallas=False``)."""
    b, n = q_emb.shape[0], ctx.ref_emb_search.shape[0]
    qf = q_emb.detach().to(ctx.ref_emb_search.dtype).reshape(b, -1)
    rf = ctx.ref_emb_search.reshape(n, -1)
    fn = l2_topk if use_kernel else l2_topk_plain
    _, ids = fn(qf, rf, ctx.ref_norms, k)
    return ids.long()


def retrieve(embed_fn: EmbedFn, batch: dict, ctx: WindowRefContext,
             k: int = 1, use_kernel: bool = True) -> dict:
    """One window-major batch -> the batch plus ``rag_emb_h1/h2``
    ``[B, K, L, D]`` and the stacked query embedding ``query_emb``."""
    af = batch["af"]
    b = batch["hap_1"].shape[0]
    toks = torch.cat([batch["hap_1"], batch["hap_2"]], dim=0)
    q = embed_fn(toks, torch.cat([af, af], dim=0))       # [2B, L, D]
    ids = search(q, ctx, k, use_kernel)                   # [2B, k]
    ret_tokens = ctx.ref_tokens[ids.reshape(-1)]          # [2Bk, L]
    ret_af = ctx.ref_af[None, :].expand_as(ret_tokens)
    ret_emb = embed_fn(ret_tokens, ret_af)
    l, d = ret_emb.shape[-2:]
    rag1, rag2 = ret_emb.chunk(2, dim=0)
    out = dict(batch)
    out["rag_emb_h1"] = rag1.reshape(b, k, l, d)
    out["rag_emb_h2"] = rag2.reshape(b, k, l, d)
    out["query_emb"] = q
    return out


# The token search operand's width is rounded up to this many int8 columns
# (zero columns leave distances unchanged) so the kernel loads 16 bytes at
# a time from every row.
TOKEN_ALIGN = 16


@dataclasses.dataclass
class TokenWindowContext:
    """Per-window retrieval state of the V17 token-space mode.

    ref_tokens_masked: [N, L] masked reference tokens (the search side).
    ref_tokens:        [N, L] complete tokens (what retrieval returns).
    ref_norms:         [N] float32 squared norms of the masked vectors
                       (+inf for padding rows).
    ref_search:        [N, round_up(L, 16)] int8 masked tokens, zero-padded:
                       the kernel's operand; None when a token id does not
                       fit int8 (the card then raises, see retrieve_tokens).
    """

    ref_tokens_masked: torch.Tensor
    ref_tokens: torch.Tensor
    ref_norms: torch.Tensor
    ref_search: torch.Tensor | None


@torch.no_grad()
def build_token_window_ctx(ref_tokens: torch.Tensor, window_mask: torch.Tensor,
                           valid: torch.Tensor | None = None
                           ) -> TokenWindowContext:
    """Mask the window's reference tokens and cache their norms (JAX
    retrieval.py:73-90).  One host read of the tokens' range per window
    decides whether the int8 operand exists."""
    masked = apply_token_mask(ref_tokens, window_mask)
    norms = l2_ref.squared_norms(masked)
    if valid is not None:
        norms = torch.where(valid, norms, torch.full_like(norms, float("inf")))
    lo, hi = torch.stack(torch.aminmax(masked)).tolist()
    search = None
    if -128 <= lo and hi <= 127:
        pad = -masked.shape[1] % TOKEN_ALIGN
        search = F.pad(masked.to(torch.int8), (0, pad))
    return TokenWindowContext(ref_tokens_masked=masked, ref_tokens=ref_tokens,
                              ref_norms=norms, ref_search=search)


def check_int8_vocab(model) -> None:
    """Token mode on the card searches int8 token vectors: raise unless
    every token id of the model's vocabulary fits int8 (the query side of
    ``retrieve_tokens``'s check; callers that know the model make it)."""
    vocab = model.bert.embedding.Embed_0.num_embeddings
    if vocab > 128:
        raise ValueError(f"token-space RAG on the card needs token ids that "
                         f"fit int8; the vocabulary has {vocab}")


def retrieve_tokens(batch: dict, ctx: TokenWindowContext, k: int = 1,
                    use_kernel: bool = True) -> dict:
    """One ``[2B, L]`` search of both haplotypes' masked tokens against the
    window's masked references -> the batch plus ``rag_seg_h1/h2``
    ``[B, k, L]``, the retrieved complete token segments (JAX
    retrieval.py:93-125).

    On the card the search always launches ``l2_topk_rf``, in serving and
    in training (the JAX package takes XLA below 16,384 refs: a TPU speed
    choice; the ids are the same).  The kernel takes int8: a reference
    token id outside [-128, 127] raises on the card rather than falling
    back to the plain version, and the query tokens must come from the
    same vocabulary (the imputer and trainer check its size).
    ``use_kernel=False`` takes the plain version even on the card."""
    q = torch.cat([batch["hap_1"], batch["hap_2"]], dim=0)
    if use_kernel and ctx.ref_search is not None:
        qp = F.pad(q.to(torch.int8), (0, ctx.ref_search.shape[1] - q.shape[1]))
        _, ids = l2_topk_rf(qp, ctx.ref_search, ctx.ref_norms, k)
    elif use_kernel and q.is_cuda:
        raise ValueError("retrieve_tokens: reference token ids outside "
                         "[-128, 127] do not fit the int8 search kernel")
    else:
        _, ids = l2_topk_rf_plain(q, ctx.ref_tokens_masked, ctx.ref_norms, k)
    i1, i2 = ids.long().chunk(2, dim=0)            # [B, k] each
    out = dict(batch)
    out["rag_seg_h1"] = ctx.ref_tokens[i1]         # [B, k, L]
    out["rag_seg_h2"] = ctx.ref_tokens[i2]
    return out
