"""What the CUDA graphs of the trainer's chunks (``train/dispatch.py``)
and of the imputer's device batches (``infer/imputer.py``) share: the key
a window context gives a graph, the context's static copy, and the
kernel counters a replay advances.

A kernel wrapper (``ops.WRAPPERS``) counts a launch each call, and
``Int8Dense`` a call; at capture nothing runs, and a replay calls no
wrapper.  So the counts made at capture are taken back (``take_back``)
and every replay adds the graph's own (``advance``): ``ops.launch_counts()``
then reads as eager execution's.
"""

from __future__ import annotations

import dataclasses

import torch


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
    returns what they counted since (a capture's: what a replay makes)."""
    made = [x - y for x, y in zip(counts(), before)]
    for (_, h, a), c in zip(counters(), before):
        setattr(h, a, c)
    return made


def advance(made: list[int]) -> None:
    """Add a replay's counts (``take_back``'s return) to the counters."""
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
