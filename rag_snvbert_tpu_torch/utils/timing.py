"""Tracing: program spans and the profiler capture.

The counterpart of rag_snvbert_tpu/utils/timing.py.

  - ``span(name)``: a named region of host code.  While a ``torch.profiler``
    capture records on the calling thread it is
    ``torch.profiler.record_function(name)``, so the exported Chrome trace
    holds the span on the clock of the kernel, copy and fill records and
    each device idle gap can be laid against the host code around it.
    Otherwise it is a shared no-op, after one read of the profiler's flag
    (under a microsecond; an ungated ``record_function`` costs 6-15 us
    with the profiler off).  A span wraps host code only: it adds
    no synchronisation, device copy, event or device allocation, and never
    sits inside a CUDA graph capture.  Names are ``<layer>.<what>``
    (``trainer.epoch``, ``dispatch.chunk``, ``imputer.launch``, ...); the
    number of spans is the count of the work they wrap.
  - ``start_trace``/``stop_trace``/``profile_trace``: a ``torch.profiler``
    capture (host and, on the card, CUDA activity) that writes a Chrome
    trace (``*.pt.trace.json``) under a directory, the file
    ``tools/summarize_trace.py`` reads.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around host code, recorded as ``name`` while a
    profiler capture records on this thread (module docstring)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


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
