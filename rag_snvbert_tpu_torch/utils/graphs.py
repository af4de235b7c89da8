"""The capture and replay of CUDA graphs, for the trainer's chunks
(``train/dispatch.py``) and the imputer's device batches
(``infer/imputer.py``): ``Graphs``, one per caller on one card.

- A graph is captured once per key, which the caller builds; all of a
  caller's graphs share one memory pool and one side stream, made at the
  first capture.
- Before the capture, the caller's body runs once eagerly on the side
  stream (kernels loaded, cuBLAS handles made, autograd's streams), its
  memory from the pool (free there between replays, so the warm-up holds
  no second copy of the activations beside the pool).  The tensors the
  caller names as its state are copied before the warm-up and put back
  after it, so the warm-up changes nothing of the run.
- The capture is ``thread_local`` on the side stream, with the
  generators the caller registers, inside a span the caller names.  A
  capture that fails raises: the card never falls back to eager.
- The window context: one static copy per signature (``ctx_sig``),
  reloaded in stream order whenever the context passed in is another
  object than the last one seen.
- Launch counts: a kernel wrapper (``ops.WRAPPERS``) counts a launch
  each call, and ``Int8Dense`` a call; at capture nothing runs, and a
  replay calls no wrapper.  So the counts of the warm-up and of the
  capture are taken back, and every replay adds the graph's own:
  ``ops.launch_counts()`` reads as eager execution's.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from .timing import span


def counters() -> list[tuple[str, object, str]]:
    """The per-call counters a replay must advance, as (name, holder,
    attribute): every kernel wrapper's ``launches`` and
    ``Int8Dense.calls``."""
    from ..ops import WRAPPERS
    from ..ops.quant import Int8Dense

    return [(name, fn, "launches") for name, fn in WRAPPERS.items()] + \
        [("Int8Dense", Int8Dense, "calls")]


def counts() -> list[int]:
    """The counters' values, in ``counters()``'s order."""
    return [getattr(h, a) for _, h, a in counters()]


def take_back(before: list[int]) -> list[int]:
    """Put the counters back to ``before`` (``counts()`` read earlier);
    returns what they counted since."""
    made = [x - y for x, y in zip(counts(), before)]
    for (_, h, a), c in zip(counters(), before):
        setattr(h, a, c)
    return made


def advance(made: list[int]) -> None:
    """Add a replay's counts to the counters."""
    for (_, h, a), c in zip(counters(), made):
        setattr(h, a, getattr(h, a) + c)


def _tensor_sig(t: torch.Tensor | None):
    return None if t is None else (tuple(t.shape), t.dtype)


def ctx_sig(ctx):
    """What a graph fixes of a window context: its type, its tensors'
    shapes and types, and its other fields (a process group by identity)."""
    if ctx is None:
        return None
    return (type(ctx),) + tuple(
        _tensor_sig(v) if v is None or isinstance(v, torch.Tensor)
        else (v if isinstance(v, (int, str)) else id(v))
        for v in (getattr(ctx, f.name) for f in dataclasses.fields(ctx)))


def empty_ctx(ctx):
    """``ctx`` with a new, unfilled tensor in place of each of its own."""
    return dataclasses.replace(ctx, **{
        f.name: torch.empty_like(getattr(ctx, f.name))
        for f in dataclasses.fields(ctx)
        if isinstance(getattr(ctx, f.name), torch.Tensor)})


def load_ctx(static, ctx) -> None:
    """Copy ``ctx``'s tensors into ``static``'s (in stream order)."""
    for f in dataclasses.fields(ctx):
        src = getattr(ctx, f.name)
        if isinstance(src, torch.Tensor):
            getattr(static, f.name).copy_(src)


@dataclasses.dataclass
class Graph:
    graph: torch.cuda.CUDAGraph
    out: object         # the body's return at capture: rewritten a replay
    inputs: object      # the caller's static buffers, filled before a replay
    counts: list[int]   # launches (and Int8Dense calls) a replay makes


class Graphs:
    """The CUDA graphs of one caller on ``device`` (module docstring):
    ``by_key`` holds them, ``captures`` and ``replays`` count the graphs
    captured and their replays."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.by_key: dict = {}
        self.captures = 0
        self.replays = 0
        self._ctx: dict = {}     # signature -> [static context, source]
        self._pool = None
        self._stream = None      # warm-ups and captures run on it

    def context(self, ctx):
        """``(ctx_sig(ctx), static copy of ctx)``, the copy reloaded when
        ``ctx`` is another object than the last one seen; (None, None)
        for None."""
        if ctx is None:
            return None, None
        sig = ctx_sig(ctx)
        slot = self._ctx.get(sig)
        if slot is None:
            slot = self._ctx[sig] = [empty_ctx(ctx), None]
        if slot[1] is None or slot[1]() is not ctx:
            load_ctx(slot[0], ctx)
            slot[1] = weakref.ref(ctx)
        return sig, slot[0]

    def capture(self, key, name: str, body, inputs, state=(),
                generators=list) -> Graph:
        """``body()``'s graph under ``key``, its warm-up and capture in a
        span ``name``: ``inputs`` the static buffers the body reads,
        ``state`` the tensors the body changes in place (put back after
        the warm-up), ``generators()`` (called after the warm-up) the
        generators to register."""
        made = []

        def counted():       # each run's counts taken back, and kept
            before = counts()
            try:
                return body()
            finally:
                made.append(take_back(before))

        with span(name):
            graph, out = self._record(counted, list(state), generators)
        g = Graph(graph, out, inputs, made[-1])     # the capture's
        self.by_key[key] = g
        self.captures += 1
        return g

    def _record(self, body, state: list, generators):
        """The card's part of ``capture``: the warm-up, then the capture;
        returns the graph and what ``body`` returned under capture."""
        # detached: a clone of a parameter would make its gradient
        # accumulator here, on this stream, and the capture's backward
        # would then wait for this stream (a capture error)
        saved = [t.detach().clone() for t in state]
        cur = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        dev = self._stream.device_index
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev, self._pool)
        try:
            try:
                with torch.cuda.stream(self._stream):
                    body()
            finally:
                torch._C._cuda_endAllocateToPool(dev, self._pool)
            cur.wait_stream(self._stream)
            if state:
                with torch.no_grad():
                    torch._foreach_copy_(state, saved)
            del saved
            graph = torch.cuda.CUDAGraph()
            for g in generators():
                graph.register_generator_state(g)
            # on the warm-up's stream: the autograd nodes that accumulate
            # the parameters' gradients keep the stream they were made on
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = body()
        finally:
            # the warm-up's hold on the pool (the graph holds its own)
            torch._C._cuda_releasePool(dev, self._pool)
        return graph, out

    def replay(self, g: Graph) -> None:
        """Replay ``g`` on the current stream, after the caller has filled
        its inputs; the counters advance by its counts."""
        g.graph.replay()
        self.replays += 1
        advance(g.counts)
