"""BERT encoders: plain and V18 embedding-space RAG.

Port of rag_snvbert_tpu/models/bert.py (the V17 token-space ``BERTWithRAG``
is not ported yet).  Inputs are a flat dict of tensors:

  hap_1, hap_2        [B, L] int  masked token sequences
  pos, af, af_p       [B, L] float
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
    haplotypes stacked into one ``[2B, L]`` pass."""

    def __init__(self, vocab_size: int, dims: int = 512, n_layers: int = 12,
                 attn_heads: int = 16, dropout: float = 0.1,
                 pre_ln: bool = False, dtype: torch.dtype = torch.float32,
                 attn_dropout: float | None = None,
                 flash_attention: bool = False,
                 score_dtype: torch.dtype = torch.float32,
                 dropout_broadcast: bool = False, fused_qkv: bool = False,
                 pos_norm: str = "group"):
        super().__init__()
        self.dims = dims
        self.embedding = BERTEmbedding(vocab_size, dims, dropout, dtype=dtype)
        self.emb_fusion = EmbeddingFusionModule(dims, pos_norm=pos_norm,
                                                dtype=dtype)
        self.encoder = Encoder(n_layers, dims, attn_heads, dropout, pre_ln,
                               dtype, attn_dropout, flash_attention,
                               score_dtype, dropout_broadcast, fused_qkv)

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


class BERTWithEmbeddingRAG(BERT):
    """V18 embedding-space RAG: emb-fusion over the 4B stacked query and
    retrieved streams, ``EnhancedRareVariantFusion``, then one encoder
    pass."""

    def __init__(self, vocab_size: int, dims: int = 512, **kw):
        super().__init__(vocab_size, dims, **kw)
        self.rag_fusion = EnhancedRareVariantFusion(
            dims, dropout=kw.get("dropout", 0.1),
            dtype=self.embedding.dtype)

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
