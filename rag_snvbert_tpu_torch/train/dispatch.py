"""One dispatch per chunk of micro-steps: ``TrainerConfig.steps_per_dispatch``.

The JAX trainer runs K consecutive same-window micro-steps as one
``lax.scan`` call (rag_snvbert_tpu/train/step.py:164-188,
trainer.py:362-400), with the semantics of K single steps.  Here a chunk
runs ``step.train_steps``: on the card as one replay of a CUDA graph that
holds all its micro-steps (retrieval, forward, backward, gradient norm,
optimizer step, metric sums), so the host issues one call where it issued
thousands; on the CPU (``device="cpu"``) by calling it.

A replay equals the chunk's single steps, bit for bit:

- the graph reads static buffers: the chunk's ``[K, ...]`` batch, copied
  in before each replay, and the window context, copied in when the
  window changes (``build_token_window_ctx``'s host read stays outside, at
  the window switch).  Every copy and the replay run in order on the
  caller's current stream, the stream the prefetch thread's copies use,
  so they see the batch only after it has landed;
- the optimizer's host side (``Optimizer.advance``: counters, learning
  rate, bias corrections) runs for each micro-step before the dispatch;
  which micro-steps update is part of the graph's key, and the update
  rows go into a device buffer that the host fills before the replay;
- dropout: micro-step ``j`` draws from the ``j``-th of a set of
  generators registered with every graph, seeded before each replay with
  ``step_seed`` of its step, as ``step_generator`` seeds a single step's
  (a replay reads a registered generator's seed and offset when it
  starts); remat's recompute draws from generators set to each segment's
  entry (``models.layers.RecomputeDraws``);
- the epoch accumulator is the runner's own (``acc``), added into in
  place, and each micro-step's loss and gradient norm land in the graph's
  ``[K]`` output buffers.

A graph is captured per key (the chunk's length and update pattern, the
batch's and the context's shapes and types, deterministic mode) by
``utils.graphs.Graphs``, after an eager warm-up from a copy of the state
the chunk changes, which is then put back; the warm-up's and the
capture's launch counts are taken back and each replay adds the graph's
own, so ``ops.launch_counts()`` reads as K single steps'.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.layers import RecomputeDraws, set_recompute_draws
from ..utils.graphs import Graphs
from ..utils.timing import span
from . import metrics
from .schedule import Optimizer
from .step import StepConfig, step_generator, step_seed, train_steps

OUTPUTS = ("loss", "grad_norm")


def epoch_accumulator(device) -> dict:
    """An epoch's counters and loss totals, zeros on ``device``."""
    def zero():
        return torch.zeros((), device=device)

    return {"counters": metrics.zeros_like_counters(device),
            "totals": {"loss": zero(), "hap_loss": zero(),
                       "gt_loss": zero()}}


def _leaves(tree: dict) -> list[torch.Tensor]:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def check_capturable(mesh) -> None:
    """Raise ``ValueError`` for a combination whose chunk cannot be
    captured on the card: a process group over gloo (its collectives
    stage CUDA tensors through host memory)."""
    if mesh is None:
        return
    import torch.distributed as dist

    if dist.get_backend() != "nccl":
        raise ValueError(
            f"steps_per_dispatch > 1 on the card with a mesh over "
            f"{dist.get_backend()}: its collectives move CUDA tensors "
            f"through host memory, which a CUDA graph cannot capture; use "
            f"nccl or steps_per_dispatch=1")


class ChunkRunner:
    """Runs chunks of micro-steps of one trainer (``train_steps``), one
    dispatch each; ``acc`` is the epoch accumulator the chunks add into
    (``zero_acc()`` at an epoch's start).  ``seed``: the run's dropout
    seed; ``data_group``, ``rows``: as ``train_step``'s.  ``graphs``: the
    chunks' CUDA graphs on the card (``utils.graphs.Graphs``; None on the
    CPU, where the body runs eagerly)."""

    def __init__(self, model, optimizer: Optimizer, cfg: StepConfig,
                 seed: int, data_group=None, rows=None, mesh=None):
        self.model, self.optimizer, self.cfg = model, optimizer, cfg
        self.seed, self.data_group, self.rows = seed, data_group, rows
        self.device = optimizer.params[0].device
        self.graphs = None
        if self.device.type == "cuda":
            check_capturable(mesh)
            self.graphs = Graphs(self.device)
        self.acc = epoch_accumulator(self.device)
        self._gens: list[torch.Generator] = []        # micro-step j's
        self._replay_gens: list[list[torch.Generator]] = []

    def zero_acc(self) -> dict:
        for t in _leaves(self.acc):
            t.zero_()
        return self.acc

    def run(self, batches: dict, ctx, step: int) -> dict:
        """One chunk: ``batches`` leaves ``[n, ...]`` (one window), ``ctx``
        the window's context, ``step`` the first micro-step's number.
        Returns ``{"loss", "grad_norm"}``, ``[n]`` device tensors (on the
        card the graph's buffers, rewritten by its next replay).  A span
        ``dispatch.chunk`` wraps it (``dispatch.capture`` a capture inside
        it, outside the graph's capture region)."""
        with span("dispatch.chunk"):
            return self._run(batches, ctx, step)

    def _run(self, batches: dict, ctx, step: int) -> dict:
        n = next(iter(batches.values())).shape[0]
        plan, rows = [], []
        for _ in range(n):
            acc_n, row = self.optimizer.advance()
            plan.append((acc_n, None if row is None else len(rows)))
            if row is not None:
                rows.append(row)
        rows = np.stack(rows) if rows else np.zeros((0, 3), np.float32)
        if self.graphs is None:
            out = {k: torch.empty(n, device=self.device) for k in OUTPUTS}
            gens = [step_generator(self.seed, step + j, self.device)
                    for j in range(n)]
            train_steps(self.model, self.optimizer, batches, ctx, self.cfg,
                        gens, plan, torch.from_numpy(rows), self.acc, out,
                        self.data_group, self.rows)
            return out
        return self._replay(batches, ctx, plan, rows, step)

    # ---- graphs ----

    def _generators(self, n: int, segments: list[int]):
        while len(self._gens) < n:
            self._gens.append(torch.Generator(device=self.device))
            self._replay_gens.append([])
        for j, b in enumerate(segments):
            while len(self._replay_gens[j]) < b:
                self._replay_gens[j].append(
                    torch.Generator(device=self.device))
        return self._gens[:n], [self._replay_gens[j][:b]
                                for j, b in enumerate(segments)]

    def _seed(self, step: int, n: int, offsets: list) -> None:
        for j in range(n):
            s = step_seed(self.seed, step + j)
            self._gens[j].manual_seed(s)
            for r, off in zip(self._replay_gens[j], offsets[j]):
                r.manual_seed(s)
                r.set_offset(off)

    def _state(self) -> list[torch.Tensor]:
        """Every tensor a chunk changes in place."""
        opt = self.optimizer
        return [*opt.params, *opt.mu, *opt.nu, *(opt.acc or []),
                *_leaves(self.acc)]

    def _capture(self, key, plan, batches: dict, ctx, rows, step: int):
        n = len(plan)
        static = {k: v.clone() for k, v in batches.items()}
        sched = torch.zeros(max(len(rows), 1), 3, device=self.device)
        _fill(sched, rows)
        out = {k: torch.empty(n, device=self.device) for k in OUTPUTS}
        gens, _ = self._generators(n, [0] * n)
        self._seed(step, n, [[]] * n)
        warm = RecomputeDraws(gens)   # records each segment's entry offset
        draws = [warm]

        def body():
            set_recompute_draws(draws[-1])
            try:
                train_steps(self.model, self.optimizer, static, ctx,
                            self.cfg, gens, plan, sched, self.acc, out,
                            self.data_group, self.rows)
            finally:
                set_recompute_draws(None)
            return out

        def generators():
            _, replay = self._generators(n, [len(o) for o in warm.offsets])
            draws.append(RecomputeDraws(gens, replay))
            return gens + [r for rs in replay for r in rs]

        return self.graphs.capture(
            key, "dispatch.capture", body, (static, sched, warm.offsets),
            self._state(), generators)

    def _replay(self, batches: dict, ctx, plan, rows, step: int) -> dict:
        sig, static_ctx = self.graphs.context(ctx)
        key = (tuple((a, u is not None) for a, u in plan),
               tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(batches.items())),
               sig, torch.are_deterministic_algorithms_enabled())
        g = self.graphs.by_key.get(key)
        if g is None:
            g = self._capture(key, plan, batches, static_ctx, rows, step)
        static, sched, offsets = g.inputs
        for k, v in batches.items():
            static[k].copy_(v)
        _fill(sched, rows)
        self._seed(step, len(plan), offsets)
        self.graphs.replay(g)
        return g.out


def _fill(sched: torch.Tensor, rows) -> None:
    """The update rows into the graph's buffer, in stream order."""
    for u, row in enumerate(rows):
        for i, v in enumerate(row):
            sched[u, i].fill_(float(v))
