"""Reading a ``torch.profiler`` Chrome trace: device busy time, kernels
by name, idle gaps.

The event grouping is a frozen copy of
``rag_snvbert_tpu_torch/tools/summarize_trace.py``'s arithmetic: complete
events (``"ph": "X"``) whose category is ``kernel``, ``gpu_memcpy`` or
``gpu_memset`` are device work; the rest are host work.  Busy time is the
length of the union of the device intervals (two streams that overlap
count once); idle gaps are the holes in that union inside the traced
window, each named by the innermost host span of the benchmark
(``bench.*``) or, failing one, the longest host operation around the
gap's middle."""

from __future__ import annotations

import collections
import dataclasses
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_class(name: str) -> str:
    """A kernel's name without template arguments, parameters or a leading
    ``void ``/namespace (``attention_fwd_kernel<64, ...>`` ->
    ``attention_fwd_kernel``)."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0]
    return name.rsplit("::", 1)[-1]


def load_events(path: str) -> list[dict]:
    with open(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def union_length(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def gaps(intervals, lo, hi) -> list[tuple[float, float]]:
    """The holes of the union of ``intervals`` inside ``[lo, hi]``."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Trace:
    """Device work of a traced window: ``device`` ``[(start_us, end_us,
    name)]``, ``host`` ``[(start_us, end_us, name)]``, and the window
    ``[lo_us, hi_us]``."""

    device: list
    host: list
    lo: float
    hi: float

    @classmethod
    def from_events(cls, events: list[dict], lo=None, hi=None) -> "Trace":
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            (dev if e.get("cat") in DEVICE_CATS else host).append(
                (a, b, e.get("name", "")))
        if lo is None:
            lo = min((a for a, _, _ in dev + host), default=0.0)
        if hi is None:
            hi = max((b for _, b, _ in dev + host), default=0.0)
        dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev
               if b > lo and a < hi]
        return cls(device=dev, host=host, lo=lo, hi=hi)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return union_length([(a, b) for a, b, _ in self.device]) / 1e6

    def kernel_seconds(self, pattern: str) -> tuple[int, float]:
        """``(calls, seconds)`` of the device events whose kernel class
        is ``pattern`` (a regular expression, matched whole)."""
        rx = re.compile(pattern)
        hits = [(b - a) for a, b, n in self.device
                if rx.fullmatch(kernel_class(n))]
        return len(hits), sum(hits) / 1e6

    def top_ops(self, n: int = 10) -> list:
        acc: collections.Counter = collections.Counter()
        for a, b, name in self.device:
            acc[kernel_class(name)] += (b - a) / 1e6
        return [[k, v] for k, v in acc.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        holes = gaps([(a, b) for a, b, _ in self.device], self.lo, self.hi)
        holes.sort(key=lambda g: g[1] - g[0], reverse=True)
        out = []
        for a, b in holes[:n]:
            mid = (a + b) / 2
            around = [(hb - ha, ha, nm) for ha, hb, nm in self.host
                      if ha <= mid <= hb]
            spans = [x for x in around if x[2].startswith("bench.")]
            if spans:        # the innermost benchmark span
                name = min(spans)[2]
            elif around:
                name = max(around)[2]
            else:
                name = "host (no traced operation)"
            out.append([name, (b - a) / 1e6])
        return out
