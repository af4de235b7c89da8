"""BERT encoders: plain, V17 token-space RAG and V18 embedding-space RAG.

Port of rag_snvbert_tpu/models/bert.py.  Inputs are a flat dict of
tensors:

  hap_1, hap_2        [B, L] int  masked token sequences
  pos, af, af_p       [B, L] float
  rag_seg_h1/h2       [B, K, L] int      (V17 token-space RAG)
  rag_emb_h1/h2       [B, K, L, D] float (V18 embedding-space RAG)
  query_emb           [2B, L, D] (optional: retrieval already embedded
                      the stacked query tokens)

Both return ``(h1, h2, h1_origin, h2_origin)``.
"""

from __future__ import annotations

import torch
from torch import nn

from .embeddings import BERTEmbedding
from .fusion import EmbeddingFusionModule, EnhancedRareVariantFusion
from .transformer import Encoder


class BERT(nn.Module):
    """Dual-haplotype encoder: shared embedding + fusion + N blocks, both
    haplotypes stacked into one ``[2B, L]`` pass.  ``remat``: the
    encoder's activation checkpointing (``transformer.py``), for every
    pass through it."""

    def __init__(self, vocab_size: int, dims: int = 512, n_layers: int = 12,
                 attn_heads: int = 16, dropout: float = 0.1,
                 pre_ln: bool = False, dtype: torch.dtype = torch.float32,
                 attn_dropout: float | None = None,
                 flash_attention: bool = False,
                 score_dtype: torch.dtype = torch.float32,
                 dropout_broadcast: bool = False, fused_qkv: bool = False,
                 pos_norm: str = "group", int8_matmuls: bool | str = False,
                 remat: bool | str = False):
        super().__init__()
        self.dims = dims
        self.embedding = BERTEmbedding(vocab_size, dims, dropout, dtype=dtype)
        self.emb_fusion = EmbeddingFusionModule(dims, pos_norm=pos_norm,
                                                dtype=dtype)
        self.encoder = Encoder(n_layers, dims, attn_heads, dropout, pre_ln,
                               dtype, attn_dropout, flash_attention,
                               score_dtype, dropout_broadcast, fused_qkv,
                               int8_matmuls, remat)

    def embed(self, tokens: torch.Tensor, af: torch.Tensor) -> torch.Tensor:
        """Embedding-layer forward: the retrieval encoder."""
        return self.embedding(tokens, af=af, pos=True)

    def encode(self, emb, pos, af):
        return self.encoder(self.emb_fusion(emb, pos, af))

    def forward(self, x: dict):
        b = x["hap_1"].shape[0]
        toks = torch.cat([x["hap_1"], x["hap_2"]], dim=0)
        af2 = torch.cat([x["af"], x["af"]], dim=0)
        pos2 = torch.cat([x["pos"], x["pos"]], dim=0)
        origin = self.embed(toks, af2)
        enc = self.encode(origin, pos2, af2)
        return enc[:b], enc[b:], origin[:b], origin[b:]


class BERTWithRAG(BERT):
    """V17 token-space RAG: the retrieved complete token segments are
    re-encoded through the whole embedding + fusion + encoder stack and
    fused into each haplotype's encoding by ``EnhancedRareVariantFusion``
    (JAX bert.py:87-117).  The queries and every retrieved segment ride one
    stacked ``[2B (1 + K), L]`` pass: every weight is shared, and each row
    is computed on its own, so this equals the JAX package's three
    passes.  The JAX package folds K into the batch and "relies on remat
    for the memory trade" (bert.py:96-101): ``remat`` checkpoints this
    pass too."""

    def __init__(self, vocab_size: int, dims: int = 512, **kw):
        super().__init__(vocab_size, dims, **kw)
        # Built with its default dropout 0.1 whatever the model's rate, as
        # in the JAX package (bert.py:94-95).
        self.rag_fusion = EnhancedRareVariantFusion(
            dims, dtype=self.embedding.dtype)

    def forward(self, x: dict):
        b = x["hap_1"].shape[0]
        af2 = torch.cat([x["af"], x["af"]], dim=0)
        pos2 = torch.cat([x["pos"], x["pos"]], dim=0)
        segs = torch.cat([x["rag_seg_h1"], x["rag_seg_h2"]], dim=0)
        k, l = segs.shape[1], segs.shape[2]          # segs [2B, K, L]
        # Segment j of row i is row i * K + j of the fold, with row i's
        # positions and frequencies (JAX encode_rag_segments).
        af_all = torch.cat([af2, af2.repeat_interleave(k, dim=0)], dim=0)
        pos_all = torch.cat([pos2, pos2.repeat_interleave(k, dim=0)], dim=0)
        toks = torch.cat([x["hap_1"], x["hap_2"], segs.reshape(-1, l)], dim=0)
        emb = self.embed(toks, af_all)
        enc = self.encode(emb, pos_all, af_all)
        rag = enc[2 * b:].reshape(2 * b, k, l, -1)    # [2B, K, L, D]
        af_p = x["af_p"]
        h = self.rag_fusion(enc[: 2 * b], rag, af2,
                            torch.cat([af_p, af_p], dim=0))
        return h[:b], h[b:], emb[:b], emb[b: 2 * b]


class BERTWithEmbeddingRAG(BERT):
    """V18 embedding-space RAG: emb-fusion over the 4B stacked query and
    retrieved streams, ``EnhancedRareVariantFusion``, then one encoder
    pass."""

    def __init__(self, vocab_size: int, dims: int = 512, **kw):
        super().__init__(vocab_size, dims, **kw)
        # The JAX package builds this module with its default dropout 0.1,
        # whatever the model's rate (bert.py:128-129); so does the port.
        self.rag_fusion = EnhancedRareVariantFusion(
            dims, dtype=self.embedding.dtype)

    def forward(self, x: dict):
        b = x["hap_1"].shape[0]
        pos, af = x["pos"], x["af"]
        af_p = x.get("af_p", af)
        af2 = torch.cat([af, af], dim=0)
        pos2 = torch.cat([pos, pos], dim=0)
        if "query_emb" in x:
            origin = x["query_emb"]
        else:
            toks = torch.cat([x["hap_1"], x["hap_2"]], dim=0)
            origin = self.embed(toks, af2)                   # [2B, L, D]

        if "rag_emb_h1" in x:
            # K > 1 retrieved refs are averaged before fusion.
            rag1, rag2 = x["rag_emb_h1"], x["rag_emb_h2"]
            rag1 = rag1.mean(dim=1) if rag1.shape[1] > 1 else rag1[:, 0]
            rag2 = rag2.mean(dim=1) if rag2.shape[1] > 1 else rag2[:, 0]
            streams = torch.cat([origin, rag1.to(origin.dtype),
                                 rag2.to(origin.dtype)], dim=0)  # [4B, L, D]
            fused = self.emb_fusion(streams, torch.cat([pos2, pos2], dim=0),
                                    torch.cat([af2, af2], dim=0))
            queries, rags = fused[: 2 * b], fused[2 * b:]
            h = self.rag_fusion(queries, rags[:, None], af2,
                                torch.cat([af_p, af_p], dim=0))
        else:
            h = self.emb_fusion(origin, pos2, af2)
        enc = self.encoder(h)
        return enc[:b], enc[b:], origin[:b], origin[b:]
