"""Completion-forced benchmarking utilities.

The counterpart of rag_snvbert_tpu/utils/benchmarking.py.  PyTorch returns
from a CUDA call before the card finishes it, so timing:

  1. forces completion: ``torch.cuda.synchronize()`` on the device of a
     CUDA result (a CPU result is complete when it is returned);
  2. measures at two iteration counts and reports the slope, which cancels
     the fixed cost of the launches' first enqueue and of the sync.

On CPU tensors (the tests) only the host clock is read.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            found = _first_tensor(x)
            if found is not None:
                return found
    return None


def fetch_scalar(tree) -> float:
    """Force completion of the work behind ``tree`` (a tensor, or nested
    lists, tuples and dicts of them) and return one element of its first
    tensor as a float (0.0 if it holds none)."""
    leaf = _first_tensor(tree)
    if leaf is None:
        return 0.0
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[0]) if leaf.numel() else 0.0


def steady_state_ms(fn: Callable, *args, iters_lo: int = 2,
                    iters_hi: int = 10, warmup: int = 1) -> dict:
    """Per-iteration wall time via the two-point slope method.

    ``fn(*args)`` returns tensors.  Returns the slope estimate (per-iter
    ms, sync overhead cancelled) and both raw points."""
    for _ in range(warmup):
        fetch_scalar(fn(*args))

    def run(n):
        t0 = time.perf_counter()
        r = None
        for _ in range(n):
            r = fn(*args)
        fetch_scalar(r)
        return time.perf_counter() - t0

    t_lo = run(iters_lo)
    t_hi = run(iters_hi)
    slope = (t_hi - t_lo) / (iters_hi - iters_lo)
    return {
        "per_iter_ms": slope * 1e3,
        "raw_lo_ms": t_lo / iters_lo * 1e3,
        "raw_hi_ms": t_hi / iters_hi * 1e3,
        "iters": (iters_lo, iters_hi),
    }


def chained_state_ms(step: Callable, state, *args, iters_lo: int = 2,
                     iters_hi: int = 8) -> dict:
    """Like steady_state_ms for stateful steps ``state, aux = step(state,
    *args)`` where each call consumes the previous state."""
    state, aux = step(state, *args)
    fetch_scalar(aux)

    def run(n, st):
        t0 = time.perf_counter()
        aux = None
        for _ in range(n):
            st, aux = step(st, *args)
        fetch_scalar(aux)
        return time.perf_counter() - t0, st

    t_lo, state = run(iters_lo, state)
    t_hi, state = run(iters_hi, state)
    slope = (t_hi - t_lo) / (iters_hi - iters_lo)
    return {
        "per_iter_ms": slope * 1e3,
        "raw_lo_ms": t_lo / iters_lo * 1e3,
        "raw_hi_ms": t_hi / iters_hi * 1e3,
        "state": state,
    }
