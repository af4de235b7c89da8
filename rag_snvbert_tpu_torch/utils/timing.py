"""Tracing and profiling utilities.

The counterpart of rag_snvbert_tpu/utils/timing.py.  The reference's
observability is a wall-clock ``timer`` decorator (src/dataset/
utils.py:23-36); this module keeps it and adds:
  - ``Phase``: nestable named phase timers with a summary table;
  - ``profile_trace``: a context manager around ``torch.profiler`` (host
    and, where a card is present, CUDA activity) that writes a Chrome trace
    (``*.pt.trace.json``) under a directory, the file
    ``tools/summarize_trace.py`` reads;
  - ``annotate``: ``torch.profiler.record_function``, a named region inside
    the trace.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import logging
import os
import time

import torch

log = logging.getLogger("rag_snvbert_tpu_torch")


def timer(fn):
    """Wall-clock decorator (reference parity: utils.py:23-36)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        log.info("%s took %.3fs", getattr(fn, "__qualname__", fn.__name__),
                 time.time() - t0)
        return out

    return wrapper


class Phase:
    """Accumulating named phase timers.

    >>> phases = Phase()
    >>> with phases("retrieval"): ...
    >>> with phases("forward"): ...
    >>> phases.summary()  # {'retrieval': {'total_s': ..., 'count': ...}, ...}
    """

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
                for k, v in self.totals.items()}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def start_trace(device=None) -> torch.profiler.profile:
    """Start a ``torch.profiler`` capture of host operations and, on a
    CUDA ``device``, its kernels; the device is synchronised first so the
    trace starts clean.  End it with ``stop_trace``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, logdir: str,
               device=None) -> str:
    """Synchronise ``device`` (so the traced work is on the trace), stop
    ``prof`` and write its Chrome trace under ``logdir``; returns the
    file's path."""
    _sync(device)
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{int(time.time() * 1e3)}"
                                f".pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profile_trace(logdir: str, device=None):
    """Capture a ``torch.profiler`` trace of the block into ``logdir``."""
    prof = start_trace(device)
    try:
        yield prof
    finally:
        stop_trace(prof, logdir, device)


def annotate(name: str):
    """Named region inside a trace."""
    return torch.profiler.record_function(name)
