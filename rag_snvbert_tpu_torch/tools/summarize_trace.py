"""Summarize a torch.profiler Chrome trace into a top-ops table.

The port of tools/summarize_trace.py.  Reads the newest ``*.pt.trace.json``
(or ``.json.gz``) under the given directory, the file that
``utils/timing.py`` and ``Trainer(profile_dir=...)`` write, groups the
complete events (``"ph": "X"``) by name per track, and prints:

  - the busy time and traced span of each track (a device track is a CUDA
    stream: ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; a host
    track is a thread: ``cpu_op``, ``cuda_runtime`` and annotations),
  - the top ops by accumulated duration with their share of the busy time.

With ``--classes`` it also groups a device track's kernels by name with
their template arguments cut off (``attention_fwd_kernel<64, ...>`` ->
``attention_fwd_kernel``).  Host tracks carry nested events (an
``aten::linear`` holds its ``aten::mm``), so their busy time double counts
and only their ranking means anything.

    python -m rag_snvbert_tpu_torch.tools.summarize_trace runs/x/profile
    python -m rag_snvbert_tpu_torch.tools.summarize_trace runs/x/profile \
        --top 25 --classes
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(root: str) -> str:
    if os.path.isfile(root):
        return root
    pats = sorted(glob.glob(os.path.join(root, "**", "*.json*"),
                            recursive=True), key=os.path.getmtime)
    pats = [p for p in pats if p.endswith((".json", ".json.gz"))]
    if not pats:
        sys.exit(f"no *.json trace under {root}")
    return pats[-1]


def load_events(path: str) -> list[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def kernel_class(name: str) -> str:
    """A kernel's name without template arguments, parameters or a leading
    ``void ``/namespace."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0]
    return name.rsplit("::", 1)[-1]


def summarize(events: list[dict], top: int = 20, track: str | None = None,
              classes: bool = False) -> str:
    """The table as text (see the module docstring)."""
    pnames: dict = {}
    tnames: dict = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pnames[e["pid"]] = e.get("args", {}).get("name", str(e["pid"]))
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            tnames[(e["pid"], e.get("tid"))] = e.get("args", {}).get(
                "name", "")
    want = re.compile(track) if track else None
    per_track = collections.defaultdict(
        lambda: (collections.Counter(), collections.Counter()))
    span = collections.defaultdict(lambda: [float("inf"), 0.0])
    device = set()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        pname = pnames.get(e["pid"], str(e["pid"]))
        tname = tnames.get((e["pid"], e.get("tid")), str(e.get("tid", "")))
        key = f"{pname} / {tname}" if tname else pname
        if want and not want.search(key):
            continue
        if e.get("cat") in DEVICE_CATS:
            device.add(key)
        durs, counts = per_track[key]
        durs[e["name"]] += float(e["dur"])
        counts[e["name"]] += 1
        lo, hi = span[key]
        span[key] = [min(lo, float(e["ts"])),
                     max(hi, float(e["ts"]) + float(e["dur"]))]
    out = []
    for key in sorted(per_track, key=lambda k: (k not in device,
                                                -sum(per_track[k][0]
                                                     .values()))):
        durs, counts = per_track[key]
        total_us = sum(durs.values())
        lo, hi = span[key]
        wall_us = hi - lo
        if total_us < 100:            # idle threads carry no signal
            continue
        kind = "device" if key in device else "host"
        out.append(f"\n== {kind} {key}: {total_us / 1e3:.3f} ms busy over "
                   f"{wall_us / 1e3:.3f} ms span "
                   f"({100 * total_us / max(wall_us, 1):.0f}% occupancy)")
        out.append(f"{'op':70s} {'calls':>6s} {'total ms':>10s} "
                   f"{'%busy':>6s}")
        for name, us in durs.most_common(top):
            out.append(f"{name[:70]:70s} {counts[name]:6d} "
                       f"{us / 1e3:10.3f} {100 * us / total_us:6.1f}")
        if classes and key in device:
            by_class: collections.Counter = collections.Counter()
            n_class: collections.Counter = collections.Counter()
            for name, us in durs.items():
                by_class[kernel_class(name)] += us
                n_class[kernel_class(name)] += counts[name]
            out.append("\nby kernel class:")
            for cls, us in by_class.most_common(top):
                out.append(f"{cls[:60]:60s} {n_class[cls]:6d} "
                           f"{us / 1e3:10.3f} ms {100 * us / total_us:5.1f}%")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", help="a trace file or a directory holding one")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--track", default=None,
                    help="only tracks whose 'process / thread' name "
                         "matches this regex")
    ap.add_argument("--classes", action="store_true",
                    help="also group each device track's kernels by name "
                         "without template arguments")
    args = ap.parse_args(argv)
    path = find_trace(args.dir)
    print(f"trace: {path}", file=sys.stderr)
    print(summarize(load_events(path), args.top, args.track, args.classes))


if __name__ == "__main__":
    main()
