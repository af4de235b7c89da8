"""Transformer encoder: multi-head attention, feed-forward, blocks (post-LN
reference topology or pre-LN), and the layer stack.

Port of rag_snvbert_tpu/models/transformer.py.  Attention routes by what
it sees, with no flag:

  - float32 CUDA q, k and v of head dim 32 (the kernels' instance),
    float32 scores and no mask: the fused float32 kernels
    (``ops/attention_f32.py``), handed the attention dropout's draws by
    ``attn_drop.draws`` (those the einsum path's dropout makes its mask
    from), which the kernel compares and applies inside, whatever
    ``flash_attention`` says (upstream V18 and V17 take this path);
  - else ``flash_attention`` set, attention dropout 0 and no mask: the
    fused bf16 kernels (``ops/attention.py``), where the JAX package takes
    its Pallas kernel (transformer.py:207-208);
  - otherwise (the CPU, a mask, bf16 scores with dropout) the plain torch
    math below, the twin of the JAX einsum path (:220-233).

A pre-LN block's residual epilogue after each sublayer (``x +
drop(attention)``, ``x + drop(drop(leaky_relu(w_2)))``) routes the same
way: bf16 CUDA activations to the residual kernels (``ops/residual.py``,
``residual_epilogue``), everything else to PyTorch's chain.

The layer stack is an unrolled loop: no scan and no pad-once residency
(:379-399 pads to TPU block multiples; the CUDA kernels mask the ragged
tail themselves).  ``quant`` (the model's ``int8_matmuls``) builds every
projection as ``ops.quant``'s ``Int8Dense`` (:191-192, :249-250).
``tp_group`` (set by ``parallel/tp.py``'s ``shard_model``) makes
attention and the FFN Megatron-parallel: each rank holds a column slice
of query/key/value (or of each third of ``qkv``) and of ``w_1``, and the
row-parallel ``output`` and ``w_2`` products are
summed over the group.  Where the ranks hold whole heads, a rank runs
attention on its own.  Where a rank's columns split a head
(``head_split``: ``tpu_default``'s 3 heads of 128 at tp2 or tp4), it
gathers the q, k and v columns of the group, runs attention on the whole
heads its columns touch, and keeps its own columns of the context; the
gather's backward sums each head's gradient over the ranks that ran it.
GSPMD computes the same from the JAX package's column placement.

``remat`` is activation checkpointing with the JAX meanings (``Encoder``,
:336-349, :401-413), through ``layers.checkpoint``, which recomputes with
the forward's dropout masks, so no mode changes a number.  What each mode
stores for the backward pass:

  ``True``         each block's input; backward runs the block again;
  ``"save_ffn"``   each block's input, the residual stream after attention
                   and ``leaky_relu(w_1(x))`` (JAX's ``ffn_hidden``);
                   backward reruns the attention sublayer with ``w_1``, and
                   the FFN's tail;
  ``"attention"``  each attention's input (the FFN stores all it does
                   without remat); backward runs the attention again;
  ``"save_most"``  all but the einsum path's ``[B, H, L, L]`` scores,
                   probabilities and dropout mask, which backward
                   recomputes from q, k and v; the kernel paths never store
                   them (the float32 one keeps the mask as bits), so there
                   it changes nothing (as on the JAX splash path, which
                   names no tensor for the policy).

With grad disabled (serving, validation) every mode is a plain call.
Under tensor parallelism a recompute repeats the forward's all-reduces
(and a split head's gather) inside the backward pass, on every rank alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.attention_f32 import HEAD_DIM as F32_HEAD_DIM, attention_f32
from ..ops.residual import MAX_DIM as RESIDUAL_MAX_DIM, residual
from .layers import (Dropout, LayerNorm, checkpoint, column_input,
                     row_parallel)

REMAT_MODES = (False, True, "save_ffn", "attention", "save_most")


class MultiHeadAttention(nn.Module):
    """``remat``: ``True`` (the block's ``"attention"`` mode) checkpoints
    the whole forward; ``"save_most"`` only the einsum path's score ->
    softmax -> dropout -> ``probs @ v`` core.  The module docstring gives
    the routing between the kernels and the einsum path."""

    def __init__(self, heads: int, dims: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 attn_dropout: float | None = None, flash: bool = False,
                 score_dtype: torch.dtype = torch.float32,
                 fused_qkv: bool = False, quant: bool | str = False,
                 remat: bool | str = False):
        super().__init__()
        from ..ops.quant import dense_cls   # ops.quant imports models.layers

        if remat not in (False, True, "save_most"):
            raise ValueError(f"attention remat must be False, True or "
                             f"'save_most', got {remat!r}")
        Dense = dense_cls(quant)
        if dims % heads:
            raise ValueError(f"dims {dims} not divisible by heads {heads}")
        self.heads, self.dims, self.dtype = heads, dims, dtype
        self.attn_rate = dropout if attn_dropout is None else attn_dropout
        self.attn_drop = Dropout(self.attn_rate)
        self.flash = flash
        self.score_dtype = score_dtype
        self.fused_qkv = fused_qkv
        self.remat = remat
        if fused_qkv:
            self.qkv = Dense(dims, 3 * dims, dtype)
        else:
            self.query = Dense(dims, dims, dtype)
            self.key = Dense(dims, dims, dtype)
            self.value = Dense(dims, dims, dtype)
        self.output = Dense(dims, dims, dtype)
        self.tp_group = None
        # heads this rank runs attention on (tensor parallel), and where its
        # columns split a head: (first of those heads, own columns' offset
        # in them, own columns)
        self.local_heads = heads
        self.head_split: tuple[int, int, int] | None = None

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.remat is True:
            return checkpoint(self._forward, self, x, mask)
        return self._forward(x, mask)

    def _forward(self, x: torch.Tensor,
                 mask: torch.Tensor | None) -> torch.Tensor:
        b, l, _ = x.shape
        hd = self.dims // self.heads
        heads = self.local_heads
        x = column_input(x, self.qkv if self.fused_qkv else self.query,
                         self.tp_group)
        if self.head_split is not None:
            if self.fused_qkv:
                qkv = self.qkv(x).reshape(b, l, 3, -1)
            else:
                qkv = torch.stack([self.query(x), self.key(x),
                                   self.value(x)], 2)
            q, k, v = self._gather_heads(qkv, hd)
        elif self.fused_qkv:
            qkv = self.qkv(x).reshape(b, l, 3, heads, hd)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            def proj(layer):
                return layer(x).reshape(b, l, heads, hd).transpose(1, 2)

            q, k, v = proj(self.query), proj(self.key), proj(self.value)

        if (q.is_cuda and q.dtype == torch.float32 and hd == F32_HEAD_DIM
                and self.score_dtype == torch.float32 and mask is None):
            draws = self.attn_drop.draws((b, heads, l, l), q.device)
            out = attention_f32(q.contiguous(), k.contiguous(),
                                v.contiguous(), 1.0 / float(hd) ** 0.5, draws,
                                self.attn_rate if draws is not None else 0.0)
        elif self.flash and mask is None and self.attn_rate == 0.0:
            out = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            1.0 / float(hd) ** 0.5)
        elif self.remat == "save_most":
            out = checkpoint(self._core, self.attn_drop, q, k, v, mask)
        else:
            out = self._core(q, k, v, mask)
        out = out.transpose(1, 2).reshape(b, l, heads * hd)
        if self.head_split is not None:
            _, off, cols = self.head_split
            out = out[..., off:off + cols]
        return row_parallel(self.output, out, self.tp_group)

    def _gather_heads(self, qkv: torch.Tensor, hd: int):
        """``q, k, v`` ``[B, local heads, L, hd]`` of the whole heads this
        rank's columns touch, from every rank's ``[B, L, 3, columns]``."""
        from ..parallel.comm import gather_from_group

        b, l = qkv.shape[:2]
        h0 = self.head_split[0]
        full = gather_from_group(qkv, self.tp_group)
        mine = full[..., h0 * hd:(h0 + self.local_heads) * hd]
        mine = mine.reshape(b, l, 3, self.local_heads, hd)
        return (mine[:, :, i].transpose(1, 2) for i in range(3))

    def _core(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None) -> torch.Tensor:
        """The einsum path: ``dropout(softmax(q k^T / sqrt(hd))) v``."""
        sd = self.score_dtype
        score = torch.matmul(q.to(sd), k.to(sd).transpose(-1, -2))
        score = score / torch.sqrt(torch.tensor(q.shape[-1], dtype=sd))
        if mask is not None:
            score = score.masked_fill(mask == 0, -1e9)
        probs = torch.softmax(score, dim=-1).to(self.dtype)
        return torch.matmul(self.attn_drop(probs), v)


class FeedForward(nn.Module):
    """Dense -> LeakyReLU(0.1) -> LayerNorm -> Dense -> LeakyReLU(0.1) ->
    dropout; ``hidden`` is the part up to JAX's ``ffn_hidden``, ``tail``
    the rest, ``projected`` the rest up to ``w_2``'s output (a pre-LN
    block applies the LeakyReLU and ``drop`` in its residual epilogue)."""

    def __init__(self, dims: int, hidden_dims: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 dropout_broadcast: bool = False, quant: bool | str = False):
        super().__init__()
        from ..ops.quant import dense_cls

        Dense = dense_cls(quant)
        self.w_1 = Dense(dims, hidden_dims, dtype)
        self.LayerNorm_0 = LayerNorm(hidden_dims, dtype)
        self.w_2 = Dense(hidden_dims, dims, dtype)
        self.drop = Dropout(dropout, dropout_broadcast)
        self.tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.hidden(x))

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        x = column_input(x, self.w_1, self.tp_group)
        return F.leaky_relu(self.w_1(x), 0.1)

    def tail(self, h: torch.Tensor) -> torch.Tensor:
        return self.drop(F.leaky_relu(self.projected(h), 0.1))

    def projected(self, h: torch.Tensor) -> torch.Tensor:
        return row_parallel(self.w_2, self.LayerNorm_0(h), self.tp_group)


def residual_epilogue(x: torch.Tensor, f: torch.Tensor,
                      drops: tuple[Dropout, ...],
                      leaky: bool = False) -> torch.Tensor:
    """``x + drops[-1](... drops[0](act(f)))``, ``act`` LeakyReLU(0.1)
    where ``leaky``, else the identity: a pre-LN block's residual
    epilogue.  Contiguous bf16 CUDA ``x`` and ``f`` of one shape ``[B, L,
    D]``, D a multiple of 8 up to the kernels' limit, whose live dropouts
    each draw one mask along the sequence, go to the residual kernels
    (``ops/residual.py``) with the masks the dropouts draw, in order (the
    chain's draws); everything else to the chain."""
    live = [d for d in drops if d.training and d.rate != 0.0]
    if (x.is_cuda and x.dtype == f.dtype == torch.bfloat16
            and x.dim() == 3 and x.shape == f.shape
            and x.shape[-1] % 8 == 0 and x.shape[-1] <= RESIDUAL_MAX_DIM
            and x.is_contiguous() and f.is_contiguous()
            and all(d.broadcast for d in live)):
        masks = [d.keep(f.shape, f.device) for d in live]
        return residual(x, f, masks, [d.rate for d in live], leaky)
    if leaky:
        f = F.leaky_relu(f, 0.1)
    for d in drops:
        f = d(f)
    return x + f


class TransformerBlock(nn.Module):
    """``pre_ln=False``: the reference's ``dropout(LN(x + f(x)))`` per
    sublayer plus a trailing dropout; ``pre_ln=True``: standard pre-norm.
    ``remat``: one of ``REMAT_MODES`` (the module docstring says what each
    stores); ``True`` and ``"save_ffn"`` checkpoint the block here, the
    other two its attention."""

    def __init__(self, dims: int, attn_heads: int, feed_forward_hidden: int,
                 dropout: float = 0.1, pre_ln: bool = False,
                 dtype: torch.dtype = torch.float32,
                 attn_dropout: float | None = None, flash: bool = False,
                 score_dtype: torch.dtype = torch.float32,
                 dropout_broadcast: bool = False, fused_qkv: bool = False,
                 quant: bool | str = False, remat: bool | str = False):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                             f"{remat!r}")
        self.dtype, self.pre_ln, self.remat = dtype, pre_ln, remat
        self.drop = Dropout(dropout, dropout_broadcast)
        attn_remat = {"attention": True, "save_most": "save_most"}.get(
            remat, False)
        self.attention = MultiHeadAttention(
            attn_heads, dims, dropout, dtype, attn_dropout, flash,
            score_dtype, fused_qkv, quant, attn_remat)
        self.feed_forward = FeedForward(dims, feed_forward_hidden, dropout,
                                        dtype, dropout_broadcast, quant)
        self.LayerNorm_0 = LayerNorm(dims, dtype)
        self.LayerNorm_1 = LayerNorm(dims, dtype)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.remat is True:
            return checkpoint(self._block, self, x, mask)
        if self.remat == "save_ffn":
            x, h = checkpoint(self._to_ffn_hidden, self, x, mask)
            return checkpoint(self._from_ffn_hidden, self, x, h)
        return self._block(x, mask)

    def _block(self, x: torch.Tensor,
               mask: torch.Tensor | None) -> torch.Tensor:
        return self._from_ffn_hidden(*self._to_ffn_hidden(x, mask))

    def _to_ffn_hidden(self, x: torch.Tensor, mask: torch.Tensor | None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """The attention sublayer, then the FFN up to ``ffn_hidden``:
        ``(residual stream, ffn_hidden)``."""
        x = x.to(self.dtype)
        if self.pre_ln:
            x = residual_epilogue(
                x, self.attention(self.LayerNorm_0(x), mask), (self.drop,))
            return x, self.feed_forward.hidden(self.LayerNorm_1(x))
        x = self.drop(self.LayerNorm_0(x + self.attention(x, mask)))
        return x, self.feed_forward.hidden(x)

    def _from_ffn_hidden(self, x: torch.Tensor,
                         h: torch.Tensor) -> torch.Tensor:
        if self.pre_ln:
            ff = self.feed_forward
            return residual_epilogue(x, ff.projected(h), (ff.drop, self.drop),
                                     leaky=True)
        x = self.drop(self.LayerNorm_1(x + self.feed_forward.tail(h)))
        return self.drop(x)


class Encoder(nn.Module):
    """``n_layers`` blocks named ``block_{i}`` (the flax tree's names),
    each with ``remat``."""

    def __init__(self, n_layers: int, dims: int, attn_heads: int,
                 dropout: float = 0.1, pre_ln: bool = False,
                 dtype: torch.dtype = torch.float32,
                 attn_dropout: float | None = None, flash: bool = False,
                 score_dtype: torch.dtype = torch.float32,
                 dropout_broadcast: bool = False, fused_qkv: bool = False,
                 quant: bool | str = False, remat: bool | str = False):
        super().__init__()
        self.dtype = dtype
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                dims, attn_heads, 4 * dims, dropout, pre_ln, dtype,
                attn_dropout, flash, score_dtype, dropout_broadcast,
                fused_qkv, quant, remat))

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, mask)
        return x
