"""Train and eval steps: retrieval + forward + focal losses + device
metrics, and the optimizer update.

Port of rag_snvbert_tpu/train/step.py (``expand_packed`` :54-78,
``_forward`` :81-108, ``_train_core`` :148-161, ``eval_step`` :191-203).
One call of ``train_step`` is one micro-step of the JAX step: retrieval
(gradient through the query embedding and the re-embedding, none through
the search), the dual-haplotype forward, the 3/3/4 focal objective, the
metric counters, backward, and ``Optimizer.step`` (which applies an update
every ``accum_steps`` micro-steps).  Nothing here copies to the host.

``train_steps`` is the counterpart of the JAX ``train_step_scan``
(:164-188): K micro-steps over a stacked ``[K, ...]`` batch of one window,
with the optimizer's host side taken out beforehand (``Optimizer.advance``)
and nothing read back, so that ``train/dispatch.py`` captures a chunk as
one CUDA graph (``TrainerConfig.steps_per_dispatch``).

Data parallelism (``data_group``): each rank runs its rows of the global
batch; the loss is a masked sum, so the gradients, the loss terms and the
metric counters are summed over the data group (not averaged, as DDP
would): the update and the stats are then the global batch's.  Only the
data group is summed: ranks that share a data coordinate (index or model
ranks) compute the same loss.  A ``ShardedWindowRefContext`` dispatches to
``retrieve_sharded`` (JAX step.py:83-95).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..models.layers import BatchRows, set_dropout_generator
from ..parallel.comm import all_reduce
from . import losses, metrics
from .retrieval import (TokenWindowContext, WindowRefContext, retrieve,
                        retrieve_tokens)
from .sharded_retrieval import ShardedWindowRefContext, retrieve_sharded
from .schedule import Optimizer, global_norm  # noqa: F401  (re-export)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    focal_gamma: float = 2.0
    use_recon: bool = False
    rag_k: int = 1
    rare_threshold: float = 0.05
    # False takes the plain search even on the card (the twin of the JAX
    # ``use_pallas=False``); True takes the l2_topk (embedding) or
    # l2_topk_rf (token) kernel on the card.
    use_kernel: bool = True
    # the candidate merge of a sharded context: "all_gather" | "ring"
    ctx_merge: str = "all_gather"


def _labels(batch: dict) -> dict:
    return {"hap_1": batch["hap_1_label"], "hap_2": batch["hap_2_label"],
            "gt": batch["gt_label"]}


_INT_KEYS = ("hap_1", "hap_2", "hap_1_label", "hap_2_label", "gt_label",
             "mask")
_PACKED_KEYS = ("pos", "af", "feat_rows", "feat_sel")


def expand_packed(batch: dict) -> dict:
    """Undo the compact wire format of ``make_batch(packed=True)`` on the
    device: int8 tokens/labels/mask to int64, window-level ``pos``/``af``
    ``[L]`` broadcast to ``[B, L]``, and the per-population feature rows
    ``[P, L, 4]`` gathered by the ``[B]`` ``feat_sel``.  A non-packed batch
    passes through unchanged."""
    if "feat_rows" not in batch:
        return batch
    b = batch["hap_1"].shape[0]
    out = {k: batch[k].long() for k in _INT_KEYS}
    for k in ("pos", "af"):
        x = batch[k].float()
        out[k] = x[None, :].expand(b, x.shape[0])
    feats = batch["feat_rows"][batch["feat_sel"].long()]       # [B, L, 4]
    for i, name in enumerate(("af_p", "ref", "het", "hom")):
        out[name] = feats[..., i]
    for k, v in batch.items():   # pass through anything else (rag_emb_*...)
        if k not in out and k not in _PACKED_KEYS:
            out[k] = v
    return out


Context = (WindowRefContext | TokenWindowContext | ShardedWindowRefContext
           | None)


def _forward(model, batch: dict, ctx: Context, cfg: StepConfig,
             data_group=None) -> tuple[torch.Tensor, dict, dict]:
    batch = expand_packed(batch)
    if isinstance(ctx, TokenWindowContext):
        # V17: retrieval returns raw token segments, which the model
        # (BERTWithRAG) re-encodes.
        batch = retrieve_tokens(batch, ctx, cfg.rag_k, cfg.use_kernel)
    elif isinstance(ctx, ShardedWindowRefContext):
        batch = retrieve_sharded(model.embed, batch, ctx, cfg.rag_k,
                                 cfg.ctx_merge, cfg.use_kernel)
    elif ctx is not None:
        batch = retrieve(model.embed, batch, ctx, cfg.rag_k, cfg.use_kernel)
    outputs = model(batch)
    labels = _labels(batch)
    mask = batch["mask"]
    data_sum = None if data_group is None else (
        lambda t: all_reduce(t.detach().clone(), data_group))
    loss, aux = losses.total_loss(outputs, labels, mask, cfg.focal_gamma,
                                  cfg.use_recon, data_sum)
    counters = metrics.batch_counters(outputs, labels, mask, batch["af"],
                                      cfg.rare_threshold)
    return loss, aux, counters


def _accumulate(acc: dict | None, stats: dict) -> dict | None:
    """Add a step's counters and loss totals into the epoch accumulator
    ``{"counters": ..., "totals": ...}`` (device tensors), in place;
    returns it."""
    if acc is None:
        return None
    metrics.accumulate_(acc["counters"], stats["counters"])
    for k, v in acc["totals"].items():
        if k in stats:
            v.add_(stats[k])
    return acc


def _flat_sum(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """``tensors`` summed over ``group`` in one collective per dtype (new
    tensors, in order)."""
    out: list[torch.Tensor | None] = [None] * len(tensors)
    # one order on every rank (a set of dtypes iterates by hash)
    for dt in sorted({t.dtype for t in tensors}, key=str):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dt]
        flat = all_reduce(torch.cat([tensors[i].reshape(-1) for i in idx]),
                          group)
        pos = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[pos: pos + n].view_as(tensors[i])
            pos += n
    return out


def _sum_stats(loss, aux: dict, counters: dict, group):
    """The loss terms and counters of every data rank, summed."""
    leaves: list[torch.Tensor] = []

    def collect(t):
        for v in t.values():
            collect(v) if isinstance(v, dict) else leaves.append(v)

    collect(counters)
    summed = iter(_flat_sum([loss.detach(), *(v.detach() for v in
                                              aux.values()), *leaves], group))
    loss = next(summed)
    aux = {k: next(summed) for k in aux}

    def rebuild(t):
        return {k: rebuild(v) if isinstance(v, dict) else next(summed)
                for k, v in t.items()}

    return loss, aux, rebuild(counters)


def sum_gradients(optimizer: Optimizer, group) -> None:
    """Each parameter's gradient summed over the data ``group`` (a missing
    one counts as zeros), in one collective."""
    grads = _flat_sum([g.float() for g in optimizer.grads()], group)
    for p, g in zip(optimizer.params, grads):
        p.grad = g.to(p.dtype)


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of micro-step ``step`` of a run seeded ``seed``: a
    pure function of the two, so a resumed run draws what an uninterrupted
    one would (the JAX step folds ``state.step`` into its key,
    step.py:149)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return int(state[0])


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The dropout generator of micro-step ``step`` (``step_seed``)."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def _micro_step(model, optimizer: Optimizer, batch: dict, ctx: Context,
                cfg: StepConfig, generator, data_group, rows,
                update) -> dict:
    """Forward, backward, the data group's sums, the raw gradient's norm,
    ``update()`` (the optimizer's step) and the gradients cleared."""
    model.train()
    set_dropout_generator(model, generator, rows)
    try:
        loss, aux, counters = _forward(model, batch, ctx, cfg, data_group)
        loss.backward()
    finally:
        set_dropout_generator(model, None)
    with torch.no_grad():
        if data_group is not None:
            sum_gradients(optimizer, data_group)
            loss, aux, counters = _sum_stats(loss, aux, counters, data_group)
        grad_norm = optimizer.grad_norm()
    update()
    optimizer.zero_grad()
    return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()},
            "counters": counters, "grad_norm": grad_norm}


def train_step(model, optimizer: Optimizer, batch: dict,
               ctx: Context, cfg: StepConfig,
               generator: torch.Generator | None = None,
               acc: dict | None = None, data_group=None,
               rows: BatchRows | None = None):
    """One micro-step in train mode with dropout drawn from ``generator``
    (needed when the model has dropout).  Returns the step's device stats
    ``{"loss", "hap_loss", "gt_loss", "counters", "grad_norm"}`` (the norm
    of this micro-step's raw gradient), or ``(stats, acc)`` when given the
    epoch accumulator ``acc`` (added into in place).  ``data_group``: sum
    the gradients and stats over the data ranks; ``rows``: this rank's rows
    of the global batch, for dropout."""
    stats = _micro_step(model, optimizer, batch, ctx, cfg, generator,
                        data_group, rows, optimizer.step)
    if acc is None:
        return stats
    return stats, _accumulate(acc, stats)


def train_steps(model, optimizer: Optimizer, batches: dict, ctx: Context,
                cfg: StepConfig, generators: list, plan: list,
                sched: torch.Tensor, acc: dict, out: dict,
                data_group=None, rows: BatchRows | None = None) -> None:
    """The micro-steps of one chunk: ``batches`` leaves are stacked
    ``[K, ...]`` (consecutive batches of one window) and micro-step ``j``
    runs ``train_step``'s body on ``batches[k][j]`` with dropout from
    ``generators[j]``.  ``plan[j]`` is the ``(n, u)`` of its optimizer
    step: ``n`` the micro-gradients the running mean holds before it and
    ``u`` the row of ``sched`` (``[U, 3]`` float32, ``Optimizer.advance``'s
    rows) it updates with, or None when it only accumulates.  The epoch
    accumulator ``acc`` is added into and ``out["loss"]``,
    ``out["grad_norm"]`` (``[K]`` float32) are written in place, and
    nothing is read back to the host: the body a CUDA graph holds
    (``train/dispatch.py``; JAX ``train_step_scan``)."""
    for j, (n, u) in enumerate(plan):
        row = None if u is None else tuple(sched[u].unbind())
        stats = _micro_step(
            model, optimizer, {k: v[j] for k, v in batches.items()}, ctx,
            cfg, generators[j], data_group, rows,
            functools.partial(optimizer.apply, n, row))
        _accumulate(acc, stats)
        out["loss"][j].copy_(stats["loss"])
        out["grad_norm"][j].copy_(stats["grad_norm"])


@torch.no_grad()
def eval_step(model, batch: dict, ctx: Context,
              cfg: StepConfig, acc: dict | None = None, data_group=None):
    """Forward-only step in eval mode; with ``acc`` returns
    ``(stats, acc')``; ``data_group`` sums the stats over the data
    ranks."""
    model.eval()
    loss, aux, counters = _forward(model, batch, ctx, cfg, data_group)
    if data_group is not None:
        loss, aux, counters = _sum_stats(loss, aux, counters, data_group)
    stats = {"loss": loss, **aux, "counters": counters}
    if acc is None:
        return stats
    return stats, _accumulate(acc, stats)
