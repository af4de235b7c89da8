"""The run of one cell: ``python -m benchmark.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``.

A cell (``cells/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``,
which names the driver ``drivers/<driver>.py``), and the metrics it
reports; each per-layer metric is read by ``metrics/<metric>.py``.  All
are found by name, so a new cell, mix, configuration or metric is a new
file.

A run: the caches go to fixed directories in the checkout; the card is
checked (a run without enough cards fails, it never falls back); the
driver's ``setup`` makes the data and weights from the seed and warms up
every shape the window uses (``setup_s`` is process start to the end of
it); its ``window`` measures for ``--seconds`` (``--trace 1``: the
traffic's ``trace_seconds``, under ``torch.profiler``); the peak device
memory is read; its ``check`` frees the program and compares what the
window produced with the plain reference (``reference/``), each number
against the cell's limit.  The last line of standard output is the
result; the numbers compared are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
# Whole top-level module names that may not be loaded in a run: the JAX
# package (``rag_snvbert_tpu``, which the port's name begins with) and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rag_snvbert_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def set_cache_env() -> None:
    """Every build and kernel cache at a fixed path in the checkout (the
    program's nvcc output is ``rag_snvbert_tpu_torch/_build/``, in the
    checkout already); no library loads JAX behind our back."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict
    config: dict
    traffic: dict

    @classmethod
    def load(cls, name: str) -> "Cell":
        spec = load_json("cells", name)
        return cls(name, spec, load_json("configs", spec["config"]),
                   load_json("traffic", spec["traffic"]))

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell, the seed, the device, a scratch
    directory under ``TMPDIR``, and overrides of the configuration's and
    traffic's values (the CPU tests' small sizes; a benchmark run has
    none)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    tmp: str
    overrides: dict = dataclasses.field(default_factory=dict)

    def param(self, key: str):
        """A value of the cell, its traffic mix, its configuration's
        ``panel`` or the configuration, in that order, unless
        overridden."""
        if key in self.overrides:
            return self.overrides[key]
        for src in (self.cell.spec, self.cell.traffic,
                    self.cell.config.get("panel", {}), self.cell.config):
            if key in src:
                return src[key]
        raise KeyError(key)

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Reading:
    """What a per-layer metric reads: the window's counters (from the
    driver), its length, the configuration, the traffic and the trace
    (``trace.Trace``, or None without ``--trace 1``)."""

    counts: dict
    window_s: float
    config: dict
    traffic: dict
    trace: object = None


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: dict | None = None) -> dict:
    """Set up, measure, check; returns the result's dict (the checks last).
    Raises on any failure of the program or the harness."""
    import torch

    driver = load_module("drivers", cell.driver)
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        run = Run(cell, seed, seconds, trace, device, tmp, overrides or {})
        state = driver.setup(run)
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        win_s = float(run.param("trace_seconds")) if trace else seconds
        tr = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            with profile(activities=acts) as prof:
                with record_function("bench.window"):
                    out = driver.window(run, state, win_s)
                if cuda:
                    torch.cuda.synchronize()
            path = os.path.join(tmp, "window.pt.trace.json")
            prof.export_chrome_trace(path)
            from .trace import Trace, load_events

            events = load_events(path)
            os.remove(path)
            win = [e for e in events if e.get("name") == "bench.window"
                   and e.get("ph") == "X"]
            lo = float(win[0]["ts"]) if win else None
            hi = lo + float(win[0]["dur"]) if win else None
            tr = Trace.from_events(events, lo, hi)
            del events
        else:
            out = driver.window(run, state, win_s)
        peak = (max(torch.cuda.max_memory_allocated(i)
                    for i in range(torch.cuda.device_count()))
                if cuda else 0)
        found = forbidden_modules()
        if found:
            raise ImportError(f"loaded during the run: {found}")
        checks = driver.check(run, state)
        del state

    result = {"correct": all(c["value"] <= c["limit"] for c in checks),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    spec = cell.spec
    if trace:
        reading = Reading(out["counts"], out["window_s"], cell.config,
                          cell.traffic, tr)
        metrics = {}
        for name in spec["per_layer"]:
            mod = load_module("metrics", name)
            value = mod.read(reading)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    else:
        metrics = {name: {"value": out["metrics"][name], "unit": unit}
                   for name, unit in spec["end_to_end"].items()
                   if name != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(spec["chips"]), "memory_peak_bytes": int(peak),
           "power_limit": card_line() if cuda else None}
    if trace:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
    result["device"] = dev
    result["counts"] = out["counts"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def _process_age() -> float:
    """Seconds since this process started (``/proc``), or 0."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    t_start = time.perf_counter() - _process_age()
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_env()
    cell = Cell.load(args.workload)

    import torch

    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {n}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", t_start)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"modules that may not be loaded were loaded: {found}",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


def _finite(x):
    """A number the result's JSON can hold: a reading that is not finite
    (a comparison with nothing to compare) prints as 1e300."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def emit(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
