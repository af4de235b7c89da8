"""Layers with flax's numerics, and seeded initialisation.

flax and torch differ in defaults that change numbers: flax ``Dense`` and
``LayerNorm`` compute in their ``dtype`` (or in the promotion of input and
parameter types when it is ``None``) from float32 parameters; ``LayerNorm``
takes eps 1e-6 and normalises in float32.  These two classes carry those
rules so every module above them matches its flax twin.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.layer_norm import layer_norm, layer_norm_plain
from ..ops.residual import keep_scaled


def _out_dtype(x: torch.Tensor, param: torch.Tensor,
               dtype: torch.dtype | None) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                               param.dtype)


class Dense(nn.Linear):
    """``flax.linen.Dense``: float32 parameters, computed in ``dtype``
    (``None``: the promotion of input and parameter types, as flax does).
    Weights are stored torch-style, ``[out, in]``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    # Under tensor parallelism (``parallel/tp.py``) a layer whose products
    # need the group inside them (``ops.quant.Int8Dense``) holds
    # ``("column" | "row", group)`` here and runs its collectives itself;
    # a ``Dense`` leaves them to ``column_input`` and ``row_parallel``.
    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _out_dtype(x, self.weight, self.compute_dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class DenseGeneral(nn.Module):
    """``flax.linen.DenseGeneral`` over the last ``len(in_shape)`` axes to
    ``out_shape`` (as flax ``MultiHeadDotProductAttention`` uses it:
    ``[D] -> [H, hd]`` for query/key/value, ``[H, hd] -> [D]`` for its
    output), computed in the promotion of input and parameter types.
    ``weight`` is stored torch-style, the output axes first:
    ``[*out_shape, *in_shape]`` (flax's kernel is ``[*in, *out]``);
    ``bias`` is ``out_shape``."""

    def __init__(self, in_shape: tuple[int, ...], out_shape: tuple[int, ...]):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.weight = nn.Parameter(torch.empty(*out_shape, *in_shape))
        self.bias = nn.Parameter(torch.zeros(out_shape))

    @property
    def fan_in(self) -> int:
        return math.prod(self.in_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _out_dtype(x, self.weight, None)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        y = F.linear(x.reshape(*lead, self.fan_in).to(dt),
                     self.weight.reshape(-1, self.fan_in).to(dt),
                     self.bias.reshape(-1).to(dt))
        return y.reshape(*lead, *self.out_shape)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: eps 1e-6, statistics in float32, output in
    ``dtype`` (``None``: promotion of input and float32).

    A bf16 CUDA input normalised into bf16 outside tensor parallelism goes
    to the LayerNorm kernels (``ops/layer_norm.py``); everything else
    (float32, the CPU, a tensor-parallel slice) to PyTorch's float32
    LayerNorm, cast to ``dtype``."""

    def __init__(self, dims: int, dtype: torch.dtype | None = None,
                 eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dims))
        self.bias = nn.Parameter(torch.zeros(dims))
        self.compute_dtype = dtype
        self.eps = eps

    # Under tensor parallelism (``parallel/tp.py``) the FFN's LayerNorm
    # holds its slice of the hidden dimension; the statistics are then
    # summed over this group.
    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _out_dtype(x, self.weight, self.compute_dtype)
        if self.tp_group is None:
            if x.is_cuda and x.dtype == dt == torch.bfloat16:
                return layer_norm(x.contiguous(), self.weight, self.bias,
                                  self.eps)
            return layer_norm_plain(x, self.weight, self.bias, self.eps, dt)
        from ..parallel.comm import all_reduce_sum

        xf = x.float()
        n = self.weight.numel() * torch.distributed.get_world_size(
            self.tp_group)
        mean = all_reduce_sum(xf.sum(-1, keepdim=True), self.tp_group) / n
        xc = xf - mean
        var = all_reduce_sum((xc * xc).sum(-1, keepdim=True),
                             self.tp_group) / n
        y = xc * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(dt)


def column_input(x: torch.Tensor, layer: Dense, group) -> torch.Tensor:
    """``x`` as the replicated input of the column-parallel ``layer``: with
    a tensor-parallel ``group``, Megatron's ``copy_to_group`` (x's gradient
    summed over the group), unless the layer sums it itself
    (``layer.tp``)."""
    if group is None or layer.tp is not None:
        return x
    from ..parallel.comm import copy_to_group

    return copy_to_group(x, group)


def row_parallel(layer: Dense, x: torch.Tensor, group) -> torch.Tensor:
    """``layer(x)``; with a tensor-parallel ``group``, ``layer`` holds the
    rows of the contraction that match ``x``'s slice: the partial products
    are summed over the group in the layer's compute dtype (as Megatron
    sums them: bf16 halves the bytes of the reduction), then the bias is
    added.  A layer with ``tp`` set sums inside its own product."""
    if group is None or layer.tp is not None:
        return layer(x)
    from ..parallel.comm import reduce_from_group

    dt = _out_dtype(x, layer.weight, layer.compute_dtype)
    y = reduce_from_group(F.linear(x.to(dt), layer.weight.to(dt)), group)
    return y + layer.bias.to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` is the tanh approximation (torch's default is erf)."""
    return F.gelu(x, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """This data-parallel rank's rows ``[start, start + count)`` of a
    global batch of ``total`` rows, so that dropout draws each mask at the
    global batch's shape and keeps the rank's rows: the masks are then
    those of one process running the whole batch.

    ``layouts`` maps a tensor's leading size to how it stacks the batch:
    a sequence of ``(groups, inner)`` segments, each ``groups`` blocks of
    ``batch x inner`` rows (``[2B]``: the two haplotypes stacked is
    ``((2, 1),)``; the ``[2B k]`` re-embedding ``((2, k),)``; V17's
    ``[2B (1 + K)]`` ``((2, 1), (2, K))``).  A size it does not list
    raises."""

    start: int
    count: int
    total: int
    layouts: tuple = ()

    @classmethod
    def stacked(cls, start: int, count: int, total: int, rag_k: int = 1,
                token_rag: bool = False) -> "BatchRows":
        """The model family's layouts: ``[2B]``, ``[2B k]`` and, for V17
        token RAG, ``[2B (1 + k)]``."""
        lay = {2: ((2, 1),), 2 * rag_k: ((2, rag_k),)}
        if token_rag:
            lay[2 * (1 + rag_k)] = ((2, 1), (2, rag_k))
        return cls(start, count, total, tuple(sorted(lay.items())))

    def select(self, n_local: int, device) -> tuple[int, torch.Tensor]:
        """``(global leading size, int64 index of this rank's rows)`` for a
        tensor of ``n_local`` rows."""
        per = dict(self.layouts).get(n_local // self.count) \
            if n_local % self.count == 0 else None
        if per is None:
            raise ValueError(f"no batch layout of {n_local} rows for "
                             f"{self.count} local rows of {self.total}")
        parts, g_off = [], 0
        for groups, inner in per:
            for g in range(groups):
                lo = g_off + (g * self.total + self.start) * inner
                # made on the device: a copy from the host would wait for
                # the stream
                parts.append(torch.arange(lo, lo + self.count * inner,
                                          device=device))
            g_off += groups * self.total * inner
        return g_off, torch.cat(parts)


def keep_draws(shape, gen: torch.Generator | None, device,
               broadcast: bool = False, rows: BatchRows | None = None,
               heads: tuple[int, int, int] | None = None) -> torch.Tensor:
    """The uniform draws from which ``keep_mask`` makes the keep mask of a
    tensor of ``shape`` on ``device``: one ``torch.rand(...)`` from ``gen``
    (never torch's global RNG), float32 in [0, 1).  ``broadcast`` draws one
    mask along the sequence axis of ``[B, L, D]`` (the JAX package's
    ``dropout_broadcast``; the draws are ``[B, 1, D]``).  ``rows`` (data
    parallelism) draws at the global batch's leading size and keeps this
    rank's rows; ``heads`` ``(lo, hi, total)`` (tensor parallelism of
    attention probabilities ``[B, H, L, L]``) draws every head and keeps
    ``lo:hi`` (a view).  Raises without a generator.  The fused float32
    attention (``ops/attention_f32.py``) takes these draws and compares
    them itself, so both paths drop the same scores."""
    return _drawn(shape, None, gen, device, broadcast, rows, heads)


def keep_mask(shape, rate: float, gen: torch.Generator | None, device,
              broadcast: bool = False, rows: BatchRows | None = None,
              heads: tuple[int, int, int] | None = None) -> torch.Tensor:
    """The bool keep mask that ``dropout`` draws for a tensor of ``shape``
    on ``device``: ``keep_draws(...) >= rate``, its arguments as there
    (compared before the rows and heads are kept)."""
    return _drawn(shape, rate, gen, device, broadcast, rows, heads)


def _drawn(shape, rate, gen, device, broadcast, rows, heads) -> torch.Tensor:
    if gen is None:
        raise RuntimeError("dropout in train mode needs a generator: call "
                           "set_dropout_generator(model, generator) first")
    draw = [shape[0], 1, shape[2]] if broadcast else list(shape)
    idx = None
    if rows is not None and rows.count != rows.total:
        draw[0], idx = rows.select(shape[0], device)
    if heads is not None:
        draw[1] = heads[2]
    out = torch.rand(draw, generator=gen, device=device)
    if rate is not None:
        out = out >= rate
    if idx is not None:
        out = out[idx]
    if heads is not None:
        out = out[:, heads[0]: heads[1]]
    return out


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None,
            broadcast: bool = False, rows: BatchRows | None = None,
            heads: tuple[int, int, int] | None = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element with probability
    ``1 - rate`` and divide the kept ones by it; the mask is the one
    ``keep_mask`` draws for ``x`` with these arguments."""
    if rate == 0.0:
        return x
    return keep_scaled(x, keep_mask(x.shape, rate, gen, x.device, broadcast,
                                    rows, heads), rate)


class Dropout(nn.Module):
    """Dropout whose draws come from the generator that
    ``set_dropout_generator`` hands it; the identity in eval mode.
    ``heads`` is set by ``parallel.tp.shard_model`` on the attention
    probabilities' dropout of a tensor-parallel model."""

    def __init__(self, rate: float, broadcast: bool = False):
        super().__init__()
        self.rate, self.broadcast = rate, broadcast
        self.generator: torch.Generator | None = None
        self.rows: BatchRows | None = None
        self.heads: tuple[int, int, int] | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return dropout(x, self.rate, self.generator, self.broadcast,
                       self.rows, self.heads)

    def keep(self, shape, device) -> torch.Tensor | None:
        """The keep mask ``forward`` would draw for an input of ``shape``;
        None in eval mode or at rate 0, where ``forward`` draws nothing."""
        d = self.draws(shape, device)
        return None if d is None else d >= self.rate

    def draws(self, shape, device) -> torch.Tensor | None:
        """The uniform draws ``forward`` would make its mask from for an
        input of ``shape`` (``keep_draws``), for a kernel that compares and
        drops inside (``ops/attention_f32.py``); None where ``keep`` is."""
        if not self.training or self.rate == 0.0:
            return None
        return keep_draws(shape, self.generator, device, self.broadcast,
                          self.rows, self.heads)


class RecomputeDraws:
    """Where ``checkpoint`` takes a recompute's dropout draws from while a
    chunk of micro-steps is warmed up and captured as a CUDA graph
    (``train/dispatch.py``).  A capture can neither read nor set a
    generator's state, so the recompute cannot rewind the step's generator
    as it does in eager mode.  Instead:

    - in the eager warm-up (``replay`` None) each checkpointed segment's
      entry records the offset of its micro-step's generator
      (``offsets[j]``, in call order);
    - under capture (``replay[j]``: one generator per segment, registered
      with the graph) segment ``b`` of micro-step ``j`` recomputes from
      ``replay[j][b]``, which the runner seeds with the step's seed and
      sets to ``offsets[j][b]`` before every replay, so it draws the
      forward's masks again.

    ``gens[j]`` is micro-step ``j``'s generator."""

    def __init__(self, gens: list, replay: list | None = None):
        self.gens = gens
        self.replay = replay
        self.offsets: list[list[int]] = [[] for _ in gens]
        self.used = [0] * len(gens)

    def enter(self, gen: torch.Generator) -> torch.Generator | None:
        """Called at a segment's forward entry with its generator."""
        j = next(i for i, g in enumerate(self.gens) if g is gen)
        if self.replay is None:
            self.offsets[j].append(gen.get_offset())
            return None
        self.used[j] += 1
        return self.replay[j][self.used[j] - 1]


_recompute_draws: RecomputeDraws | None = None


def set_recompute_draws(draws: RecomputeDraws | None) -> None:
    """Install ``draws`` for the ``checkpoint`` calls that follow (None:
    the eager rewind)."""
    global _recompute_draws
    _recompute_draws = draws


def checkpoint(fn, module: nn.Module, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    backward pass keeps only the inputs and runs ``fn`` again to get the
    rest.  The recompute draws the forward's dropout masks: every
    generator that ``module``'s ``Dropout``s hold is set to its state at
    this call for the recompute, then put back where it was (torch's
    ``preserve_rng_state`` covers only the global RNGs, which the model
    never draws from); while a CUDA graph is captured the recompute draws
    from a generator set to that state instead (``RecomputeDraws``).
    So remat changes no bit of the loss or the gradients, as the JAX
    ``nn.remat`` (which recomputes from the same key) changes none.  With
    grad disabled it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    drops = [m for m in module.modules()
             if isinstance(m, Dropout) and m.generator is not None]
    gens = list({id(m.generator): m.generator for m in drops}.values())
    replay = None
    if _recompute_draws is not None and gens:
        if len(gens) > 1:
            raise ValueError("a captured remat segment needs one dropout "
                             "generator for all its Dropouts")
        replay = _recompute_draws.enter(gens[0])
    entry = [] if replay is not None else [g.get_state() for g in gens]
    forward_done = False

    def run(*a):
        nonlocal forward_done
        if not forward_done:
            forward_done = True
            return fn(*a)
        if replay is not None:
            for m in drops:
                m.generator = replay
            try:
                return fn(*a)
            finally:
                for m in drops:
                    m.generator = gens[0]
        left = [g.get_state() for g in gens]
        for g, s in zip(gens, entry):
            g.set_state(s)
        try:
            return fn(*a)
        finally:    # also when the recompute stops early
            for g, s in zip(gens, left):
                g.set_state(s)

    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)


def set_dropout_generator(model: nn.Module, gen: torch.Generator | None,
                          rows: BatchRows | None = None) -> None:
    """Give every ``Dropout`` of ``model`` the generator to draw from (one
    per training step: the trainer seeds it from the run seed and the
    step) and, under data parallelism, the rank's rows of the batch."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = gen
            mod.rows = rows


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter from one seeded CPU generator (no global RNG).

    Dense and Conv kernels are LeCun-normal (flax's default), embeddings
    standard normal, norms one/zero, biases zero; the few named scalars
    take their flax initial values.  Serving smoke runs use these random
    weights; parity tests load flax weights instead (``interop``)."""
    g = torch.Generator().manual_seed(seed)

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float32) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, DenseGeneral)):
            fan_in = (mod.fan_in if isinstance(mod, DenseGeneral)
                      else mod.weight[0].numel())
            normal_(mod.weight, 1.0 / math.sqrt(fan_in))
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 1.0)
        elif isinstance(mod, (LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        for name, p in mod.named_parameters(recurse=False):
            if name == "res_scale":
                p.fill_(0.1)
            elif name == "basis_freqs":
                p.copy_(torch.logspace(0.0, 2.0, p.numel()))
        if hasattr(mod, "reset_stats"):
            mod.reset_stats()
    return model
