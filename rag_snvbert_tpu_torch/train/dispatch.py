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

There is one graph per key (the chunk's length and update pattern, the
batch's and the context's shapes and types, deterministic mode); all share
one memory pool.  Before a key's capture its body runs once eagerly on a
side stream (cuBLAS handles, kernels loaded, autograd's streams), from a
copy of the state it changes that is then put back, so the warm-up
changes nothing of the run.  A kernel wrapper counts one launch at
capture, where nothing runs; the runner takes that back and adds each
graph's captured launches (and ``Int8Dense`` calls) at every replay.  A
capture that fails raises: the card never runs a chunk eagerly instead.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import numpy as np
import torch

from ..models.layers import RecomputeDraws, set_recompute_draws
from ..utils.graphs import (advance, counters, counts, ctx_sig, empty_ctx,
                             load_ctx, take_back)
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


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    batches: dict          # the static [K, ...] batch
    sched: torch.Tensor    # [U, 3] update rows
    out: dict              # "loss", "grad_norm": [K] float32
    counts: list[int]      # launches (and Int8Dense calls) a replay makes
    offsets: list          # RecomputeDraws offsets a micro-step


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
    seed; ``data_group``, ``rows``: as ``train_step``'s."""

    def __init__(self, model, optimizer: Optimizer, cfg: StepConfig,
                 seed: int, data_group=None, rows=None, mesh=None):
        self.model, self.optimizer, self.cfg = model, optimizer, cfg
        self.seed, self.data_group, self.rows = seed, data_group, rows
        self.device = optimizer.params[0].device
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            check_capturable(mesh)
        self.acc = epoch_accumulator(self.device)
        self.graphs: dict = {}
        self.replays = 0
        # kernel launches (and Int8Dense calls) made inside replays
        self.replayed = {name: 0 for name, _, _ in counters()}
        self._gens: list[torch.Generator] = []        # micro-step j's
        self._replay_gens: list[list[torch.Generator]] = []
        self._ctx: dict = {}     # signature -> [static context, source]
        self._pool = None
        self._stream = None      # warm-ups and captures run on it

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
        if not self.cuda:
            out = {k: torch.empty(n, device=self.device) for k in OUTPUTS}
            gens = [step_generator(self.seed, step + j, self.device)
                    for j in range(n)]
            train_steps(self.model, self.optimizer, batches, ctx, self.cfg,
                        gens, plan, torch.from_numpy(rows), self.acc, out,
                        self.data_group, self.rows)
            return out
        return self._replay(batches, ctx, plan, rows, step)

    # ---- the card ----

    def _static_ctx(self, ctx):
        """The static copy of ``ctx``'s tensors, refreshed when ``ctx`` is
        another window's than the last one seen."""
        if ctx is None:
            return None
        sig = ctx_sig(ctx)
        slot = self._ctx.get(sig)
        if slot is None:
            slot = self._ctx[sig] = [empty_ctx(ctx), None]
        if slot[1] is None or slot[1]() is not ctx:
            load_ctx(slot[0], ctx)
            slot[1] = weakref.ref(ctx)
        return slot[0]

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

    def _capture(self, plan, batches: dict, ctx, rows, step: int) -> _Graph:
        n = len(plan)
        static = {k: torch.empty_like(v) for k, v in batches.items()}
        for k, v in batches.items():
            static[k].copy_(v)
        sched = torch.zeros(max(len(rows), 1), 3, device=self.device)
        out = {k: torch.empty(n, device=self.device) for k in OUTPUTS}
        gens, _ = self._generators(n, [0] * n)
        body = functools.partial(
            train_steps, self.model, self.optimizer, static, ctx, self.cfg,
            gens, plan, sched, self.acc, out, self.data_group, self.rows)
        for u, row in enumerate(rows):
            for i, v in enumerate(row):
                sched[u, i].fill_(float(v))
        self._seed(step, n, [[]] * n)

        # The warm-up: eager on the capture stream, its memory from the
        # graphs' pool (free there between replays, so a new key's warm-up
        # does not hold a second chunk's activations beside the pool);
        # then the state it changed is put back.
        state = self._state()
        # detached: a clone of a parameter would make its gradient
        # accumulator here, on this stream, and the capture's backward
        # would then wait for this stream (a capture error)
        saved = [t.detach().clone() for t in state]
        record = RecomputeDraws(gens)
        cur = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        dev = self._stream.device_index
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev, self._pool)
        try:
            set_recompute_draws(record)
            try:
                with torch.cuda.stream(self._stream):
                    body()
            finally:
                set_recompute_draws(None)
                torch._C._cuda_endAllocateToPool(dev, self._pool)
            cur.wait_stream(self._stream)
            with torch.no_grad():
                torch._foreach_copy_(state, saved)
            del saved

            offsets = record.offsets
            gens, replay = self._generators(n, [len(o) for o in offsets])
            graph = torch.cuda.CUDAGraph()
            for g in gens + [r for rs in replay for r in rs]:
                graph.register_generator_state(g)
            before = counts()
            set_recompute_draws(RecomputeDraws(gens, replay))
            try:
                # on the warm-up's stream: the autograd nodes that
                # accumulate the parameters' gradients keep the stream
                # they were made on
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self._stream,
                                      capture_error_mode="thread_local"):
                    body()
            finally:
                set_recompute_draws(None)
        finally:
            # the warm-up's hold on the pool (the graph holds its own)
            torch._C._cuda_releasePool(dev, self._pool)
        made = take_back(before)     # nothing ran
        return _Graph(graph, static, sched, out, made, offsets)

    def _replay(self, batches: dict, ctx, plan, rows, step: int) -> dict:
        n = len(plan)
        static_ctx = self._static_ctx(ctx)
        key = (tuple((a, u is not None) for a, u in plan),
               tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(batches.items())),
               ctx_sig(ctx), torch.are_deterministic_algorithms_enabled())
        g = self.graphs.get(key)
        if g is None:
            with span("dispatch.capture"):
                g = self.graphs[key] = self._capture(plan, batches,
                                                     static_ctx, rows, step)
        for k, v in batches.items():
            g.batches[k].copy_(v)
        for u, row in enumerate(rows):
            for i, v in enumerate(row):
                g.sched[u, i].fill_(float(v))
        self._seed(step, n, g.offsets)
        g.graph.replay()
        self.replays += 1
        advance(g.counts)
        for name, c in zip(self.replayed, g.counts):
            self.replayed[name] += c
        return g.out
