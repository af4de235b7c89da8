"""The model families in plain float32 PyTorch.

Written from the published layer equations as the program states them
(flax's numerics: LayerNorm eps 1e-6 with float32 statistics, the tanh
GELU, LeCun-initialised Dense layers stored ``[out, in]``), with the
program's parameter names so that one state dict loads into both.  Every
activation is float32; attention is ``softmax(q k^T / sqrt(hd)) v`` with
its scores materialised; there are no kernels, caches or remat.

Dropout keeps an element where a uniform draw from the step's generator is
at least the rate (``torch.rand`` of the mask's shape), in the order the
modules run: the draws are then the program's, given the same generator.
``set_precision`` selects the controls' rounded products
(``numerics.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import numerics

PAD = 0
MAX_SEQ_LEN = 1030


class Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out))
        self.mode = None

    def forward(self, x):
        return numerics.linear(x.float(), self.weight, self.bias, self.mode)


class LayerNorm(nn.Module):
    def __init__(self, dims: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dims))
        self.bias = nn.Parameter(torch.zeros(dims))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


class Dropout(nn.Module):
    def __init__(self, rate: float, broadcast: bool = False):
        super().__init__()
        self.rate, self.broadcast = rate, broadcast
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        shape = [x.shape[0], 1, x.shape[2]] if self.broadcast \
            else list(x.shape)
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def sinusoidal_table(max_len, dims, device=None):
    position = torch.arange(max_len, dtype=torch.float32,
                            device=device)[:, None]
    div_term = torch.exp(torch.arange(0, dims, 2, dtype=torch.float32,
                                      device=device)
                         * -(math.log(10000.0) / dims))
    ang = position * div_term
    pe = torch.zeros(max_len, dims, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : pe[:, 1::2].shape[1]])
    return pe


class AFEmbedding(nn.Module):
    def __init__(self, d, num_basis=32):
        super().__init__()
        self.basis_freqs = nn.Parameter(torch.logspace(0.0, 2.0, num_basis))
        self.Dense_0 = Dense(2 * num_basis, d)
        self.LayerNorm_0 = LayerNorm(d)
        self.Dense_1 = Dense(d, d)

    def forward(self, af):
        e = af[..., None] * self.basis_freqs
        feats = torch.cat([torch.sin(2 * math.pi * e),
                           torch.cos(2 * math.pi * e)], dim=-1)
        return self.Dense_1(gelu(self.LayerNorm_0(self.Dense_0(feats))))


class BERTEmbedding(nn.Module):
    def __init__(self, vocab, d, dropout):
        super().__init__()
        self.Embed_0 = nn.Embedding(vocab, d)
        self.AFEmbedding_0 = AFEmbedding(d)
        self.drop = Dropout(dropout)

    def forward(self, seq, af):
        tok = self.Embed_0(seq) * (seq != PAD)[..., None].float()
        pe = sinusoidal_table(MAX_SEQ_LEN, tok.shape[-1], tok.device)
        out = tok + pe[None, : seq.shape[-1]] + self.AFEmbedding_0(af.float())
        return self.drop(out)


class PositionFeatModule(nn.Module):
    def __init__(self, c=4, k=9):
        super().__init__()
        self.Conv_0 = nn.Conv1d(1, c, k, padding=k // 2)
        self.Conv_1 = nn.Conv1d(c, c, k, padding=k // 2)
        self.Conv_2 = nn.Conv1d(c, 1, k, padding=k // 2)
        self.GroupNorm_0 = nn.GroupNorm(1, c, eps=1e-6)
        self.GroupNorm_1 = nn.GroupNorm(1, c, eps=1e-6)

    def forward(self, pos):
        h = pos[:, None, :].float()
        h = self.GroupNorm_0(F.leaky_relu(self.Conv_0(h), 0.05))
        h = self.GroupNorm_1(F.leaky_relu(self.Conv_1(h), 0.05))
        return F.leaky_relu(self.Conv_2(h), 0.05)[:, 0]


class EmbeddingFusionModule(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.pos_feat = PositionFeatModule()
        self.fusion = Dense(d + 2, d)
        self.LayerNorm_0 = LayerNorm(d)

    def forward(self, emb, pos, af):
        feats = torch.cat([emb, self.pos_feat(pos)[..., None],
                           af[..., None].float()], dim=-1)
        return self.LayerNorm_0(emb + F.leaky_relu(self.fusion(feats), 0.1))


class CrossAFInteraction(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.Dense_0 = Dense(2, 32)
        self.Dense_1 = Dense(32, d)
        self.Dense_2 = Dense(2, d)
        self.LayerNorm_0 = LayerNorm(d)
        self.res_scale = nn.Parameter(torch.tensor(0.1))

    def forward(self, g, p):
        comb = torch.stack([g, p], dim=-1).float()
        gate = torch.sigmoid(self.Dense_1(gelu(self.Dense_0(comb))))
        enc = gelu(self.LayerNorm_0(self.Dense_2(comb)))
        return g[..., None] + self.res_scale * (gate * enc)


class EnhancedRareVariantFusion(nn.Module):
    def __init__(self, d, dropout=0.1):
        super().__init__()
        self.af_interaction = CrossAFInteraction(d)
        self.Dense_0 = Dense(d, 4 * d)
        self.Dense_1 = Dense(4 * d, d)
        self.pooling = Dense(d, 1)
        self.Dense_2 = Dense(2 * d, 4 * d)
        self.Dense_3 = Dense(4 * d, d)
        self.LayerNorm_0 = LayerNorm(d)
        self.res_scale = nn.Parameter(torch.tensor(0.1))
        self.drop = Dropout(dropout)

    def forward(self, orig, rag, g, p):       # orig [B, L, D], rag [B, K, L, D]
        fused_af = self.af_interaction(g, p)
        w = self.drop(gelu(self.Dense_0(fused_af)))
        af_w = torch.sigmoid(self.Dense_1(w))
        weighted = (rag * af_w[:, None]).transpose(1, 2)     # [B, L, K, D]
        pool_w = torch.softmax(self.pooling(weighted), dim=2)
        pooled = (weighted * pool_w).sum(dim=2)
        fused = self.drop(gelu(self.Dense_2(torch.cat([orig, pooled], -1))))
        fused = self.LayerNorm_0(self.Dense_3(fused))
        maf = torch.minimum(g, 1.0 - g)[..., None]
        maf_w = torch.clamp(torch.log1p(1.0 / (maf + 1e-6)), max=3.0)
        return orig + self.res_scale * (fused * maf_w)


class MultiHeadAttention(nn.Module):
    def __init__(self, heads, d, dropout, attn_dropout):
        super().__init__()
        self.heads, self.d = heads, d
        rate = dropout if attn_dropout is None else attn_dropout
        self.attn_drop = Dropout(rate)
        self.query, self.key, self.value = (Dense(d, d), Dense(d, d),
                                            Dense(d, d))
        self.output = Dense(d, d)
        self.mode = None

    def forward(self, x):
        b, l, _ = x.shape
        hd = self.d // self.heads

        def proj(layer):
            return layer(x).reshape(b, l, self.heads, hd).transpose(1, 2)

        q, k, v = proj(self.query), proj(self.key), proj(self.value)
        score = numerics.matmul(q, k.transpose(-1, -2), self.mode) \
            / math.sqrt(hd)
        probs = self.attn_drop(torch.softmax(score, dim=-1))
        out = numerics.matmul(probs, v, self.mode)
        return self.output(out.transpose(1, 2).reshape(b, l, self.d))


class FeedForward(nn.Module):
    def __init__(self, d, hidden, dropout, broadcast):
        super().__init__()
        self.w_1 = Dense(d, hidden)
        self.LayerNorm_0 = LayerNorm(hidden)
        self.w_2 = Dense(hidden, d)
        self.drop = Dropout(dropout, broadcast)

    def hidden(self, x):
        return F.leaky_relu(self.w_1(x), 0.1)

    def tail(self, h):
        return self.drop(F.leaky_relu(self.w_2(self.LayerNorm_0(h)), 0.1))


class TransformerBlock(nn.Module):
    def __init__(self, d, heads, dropout, pre_ln, attn_dropout, broadcast):
        super().__init__()
        self.pre_ln = pre_ln
        self.drop = Dropout(dropout, broadcast)
        self.attention = MultiHeadAttention(heads, d, dropout, attn_dropout)
        self.feed_forward = FeedForward(d, 4 * d, dropout, broadcast)
        self.LayerNorm_0 = LayerNorm(d)
        self.LayerNorm_1 = LayerNorm(d)

    def forward(self, x):
        ff = self.feed_forward
        if self.pre_ln:
            x = x + self.drop(self.attention(self.LayerNorm_0(x)))
            h = ff.hidden(self.LayerNorm_1(x))
            return x + self.drop(ff.tail(h))
        x = self.drop(self.LayerNorm_0(x + self.attention(x)))
        h = ff.hidden(x)
        x = self.drop(self.LayerNorm_1(x + ff.tail(h)))
        return self.drop(x)


class Encoder(nn.Module):
    def __init__(self, n_layers, d, heads, dropout, pre_ln, attn_dropout,
                 broadcast):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                d, heads, dropout, pre_ln, attn_dropout, broadcast))

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x)
        return x


class BERT(nn.Module):
    """``rag_mode`` ``"embedding"`` (V18) or ``"token"`` (V17)."""

    def __init__(self, vocab, dims, n_layers, heads, dropout, pre_ln,
                 attn_dropout, broadcast, rag_mode):
        super().__init__()
        self.dims, self.rag_mode = dims, rag_mode
        self.embedding = BERTEmbedding(vocab, dims, dropout)
        self.emb_fusion = EmbeddingFusionModule(dims)
        self.encoder = Encoder(n_layers, dims, heads, dropout, pre_ln,
                               attn_dropout, broadcast)
        self.rag_fusion = EnhancedRareVariantFusion(dims)

    def embed(self, tokens, af):
        return self.embedding(tokens, af)

    def forward(self, x):
        if self.rag_mode == "token":
            return self._forward_token(x)
        b = x["hap_1"].shape[0]
        af2 = torch.cat([x["af"], x["af"]], 0)
        pos2 = torch.cat([x["pos"], x["pos"]], 0)
        af_p2 = torch.cat([x["af_p"], x["af_p"]], 0)
        origin = x["query_emb"]
        rag1, rag2 = x["rag_emb_h1"].mean(1), x["rag_emb_h2"].mean(1)
        streams = torch.cat([origin, rag1, rag2], 0)
        fused = self.emb_fusion(streams, torch.cat([pos2, pos2], 0),
                                torch.cat([af2, af2], 0))
        h = self.rag_fusion(fused[: 2 * b], fused[2 * b:][:, None], af2,
                            af_p2)
        enc = self.encoder(h)
        return enc[:b], enc[b:]

    def _forward_token(self, x):
        b = x["hap_1"].shape[0]
        af2 = torch.cat([x["af"], x["af"]], 0)
        pos2 = torch.cat([x["pos"], x["pos"]], 0)
        segs = torch.cat([x["rag_seg_h1"], x["rag_seg_h2"]], 0)
        k, l = segs.shape[1], segs.shape[2]
        af_all = torch.cat([af2, af2.repeat_interleave(k, 0)], 0)
        pos_all = torch.cat([pos2, pos2.repeat_interleave(k, 0)], 0)
        toks = torch.cat([x["hap_1"], x["hap_2"], segs.reshape(-1, l)], 0)
        enc = self.encoder(self.emb_fusion(self.embed(toks, af_all),
                                           pos_all, af_all))
        rag = enc[2 * b:].reshape(2 * b, k, l, -1)
        af_p2 = torch.cat([x["af_p"], x["af_p"]], 0)
        h = self.rag_fusion(enc[: 2 * b], rag, af2, af_p2)
        return h[:b], h[b:]


class EnhancedHaplotypeClassifier(nn.Module):
    def __init__(self, d, vocab=2):
        super().__init__()
        self.Dense_0 = Dense(d + 2, 4 * d)
        self.Dense_1 = Dense(4 * d, d)
        self.LayerNorm_0 = LayerNorm(d)
        self.Dense_2 = Dense(d, 4 * d)
        self.Dense_3 = Dense(4 * d, vocab)

    def forward(self, x, g, p):
        fused = self.Dense_0(torch.cat([x, torch.stack([g, p], -1)], -1))
        fused = self.LayerNorm_0(self.Dense_1(gelu(fused)))
        return self.Dense_3(gelu(self.Dense_2(fused)))


class GenotypeClassifier(nn.Module):
    def __init__(self, hidden=16, vocab=4):
        super().__init__()
        self.Dense_0 = Dense(7, hidden)
        self.LayerNorm_0 = LayerNorm(hidden)
        self.Dense_1 = Dense(hidden, hidden)
        self.LayerNorm_1 = LayerNorm(hidden)
        self.Dense_2 = Dense(hidden, hidden)
        self.Dense_3 = Dense(hidden, vocab)

    def forward(self, p1, p2, ref, het, hom):
        feats = torch.cat([p1, p2, ref[..., None], het[..., None],
                           hom[..., None]], -1)
        h = self.LayerNorm_0(F.leaky_relu(self.Dense_0(feats), 0.01))
        f = self.LayerNorm_1(F.leaky_relu(self.Dense_1(h), 0.1))
        return self.Dense_3(F.leaky_relu(self.Dense_2(f), 0.1))


class FoundationModel(nn.Module):
    """Encoder + the two heads: ``(hap_1, hap_2, gt)`` logits."""

    def __init__(self, vocab, dims, n_layers, heads, dropout=0.1,
                 pre_ln=False, attn_dropout=None, broadcast=False,
                 rag_mode="embedding"):
        super().__init__()
        self.bert = BERT(vocab, dims, n_layers, heads, dropout, pre_ln,
                         attn_dropout, broadcast, rag_mode)
        self.hap_classifier = EnhancedHaplotypeClassifier(dims)
        self.gt_classifier = GenotypeClassifier()

    def embed(self, tokens, af):
        return self.bert.embed(tokens, af)

    def forward(self, x):
        h1, h2 = self.bert(x)
        hap_1 = self.hap_classifier(h1, x["af"], x["af_p"])
        hap_2 = self.hap_classifier(h2, x["af"], x["af_p"])
        gt = self.gt_classifier(torch.softmax(hap_1, -1),
                                torch.softmax(hap_2, -1), x["ref"],
                                x["het"], x["hom"])
        return hap_1, hap_2, gt


def from_config(model_cfg: dict, vocab: int) -> FoundationModel:
    """The reference model of a configuration file's ``model`` block."""
    m = model_cfg
    return FoundationModel(vocab, m["dims"], m["n_layers"], m["attn_heads"],
                           m["dropout"], m["pre_ln"], m["attn_dropout"],
                           m["dropout_broadcast"], m["rag_mode"])


def set_precision(model: nn.Module, mode: str | None) -> None:
    """Every product of ``model`` in ``mode`` (``numerics.py``)."""
    for mod in model.modules():
        if hasattr(mod, "mode"):
            mod.mode = mode


def set_generator(model: nn.Module, gen) -> None:
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = gen


def focal_loss(logits, targets, mask, gamma=2.0):
    logp = torch.log_softmax(logits.float(), dim=-1)
    p = torch.exp(logp)
    p_t = torch.gather(p, -1, targets.long()[..., None])[..., 0]
    loss = -((1.0 - p_t) ** gamma) * torch.log(p_t + 1e-10)
    return torch.sum(loss * mask.float())


def total_loss(outputs, batch, gamma=2.0):
    """3 * (hap_1 + hap_2) + 4 * gt focal, summed over masked sites."""
    m = batch["mask"]
    return 3.0 * (focal_loss(outputs[0], batch["hap_1_label"], m, gamma)
                  + focal_loss(outputs[1], batch["hap_2_label"], m, gamma)) \
        + 4.0 * focal_loss(outputs[2], batch["gt_label"], m, gamma)
