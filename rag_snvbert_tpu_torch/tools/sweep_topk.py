"""Sweep the int8 search kernel's plan at the genotype index shape.

The port of tools/sweep_topk.py: QPS at bench.py's shapes (N = 331 x 2008
rows, d = 2040, k = 10, 1024-query batches x ``--chunks`` 16) of
``ops.l2_topk_rf`` over a grid of plans, the refs and queries Bernoulli(0.5)
from a seeded generator on the card, stored by ``index.FlatL2Index.build``
(``--dtype int8``; ``int4``, held as int8 values; ``packed``, pack 8).

What the JAX tool sweeps are the Pallas tiles ``tq``/``tn``/``td``.  The
kernel's tiles (128 queries x 192 rows x 128 bytes of d) are compile-time
constants here; what the host chooses is the plan, ``l2_topk_rf(...,
plan=(rows, stages))``: the rows of one ref-row class a split searches
(hence the splits, and the waves of blocks on the card's SMs) and the depth
of the shared-memory ring.  ``--rows`` (default: the default plan's rows and
x1/2, x2, x4 of them, each a multiple of 192) and ``--stages`` (default:
every depth that fits) span the grid; the default plan comes first.

The JAX flags with no axis here are accepted and reported, not swept:
  - ``--compute int4`` is computed as int8: Hopper has no int4 mma, and the
    result is the same (ops/l2_topk_rf.py);
  - ``--order`` has nothing to choose: the port has one int8 kernel,
    ``l2_topk_rf``, which this tool calls directly (as the JAX tool calls
    ``l2_topk_pallas``);
  - ``--prepad`` has nothing to pad: the wrapper pads nothing (and packed
    storage is built unaligned for the same reason).

Checks: the JAX tool's numpy oracle (float32 expansion, exact for binary
vectors, stable argsort) on the first 128 queries of chunk 0, computed once;
every plan's ids must equal it exactly (the kernel's ties go to the lower
id, as a stable sort's), and JAX's ``recall_ok`` (> 99.9% equal) is printed
beside that; every plan's ids and distances over all chunks must be
bit-identical to the default plan's.  Timing: CUDA events around the
chunks after a warm-up, in turns (the grid, then the grid reversed), so the
default plan is timed first and last.  One JSON row a plan, then
``{"best": ...}`` (on the card the first line is its name and power
limit); a failed check raises after the rows.

    python -m rag_snvbert_tpu_torch.tools.sweep_topk [--dtype packed] \
        [--rows 20928,41664] [--stages 2,4] [--chunks 16]

Runs on the card unless ``--device cpu`` is given (the plain version, which
has no plan: cut ``--n-rows`` and ``--batch`` there).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops.l2_topk_rf import (_BN, _BQ, check_plan, l2_topk_rf, list_stride,
                              plan_splits, ring_stages, row_classes,
                              split_plan)

N_ROWS, D, K, BATCH = 331 * 2008, 2040, 10, 1024
H100_SMS = 132          # the plan's SM count off the card
ORACLE_QUERIES = 128
ORACLE_CHUNK = 65536    # ref rows a step of the numpy oracle


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default=None,
                    help="comma list of rows per split (multiples of 192); "
                    "default: the default plan's and x1/2, x2, x4 of it")
    ap.add_argument("--stages", default=None,
                    help="comma list of ring depths; default: every depth "
                    "that fits")
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--dtype", default="int8",
                    choices=["int8", "int4", "packed"],
                    help="index storage (int4: int8 values in [-8, 7], "
                    "searched as int8; packed: planar 8-per-byte bits)")
    ap.add_argument("--compute", default=None, choices=["int8", "int4"],
                    help="accepted, not swept: computed as int8 on Hopper")
    ap.add_argument("--order", default="auto",
                    choices=["auto", "qfirst", "rfirst"],
                    help="accepted, not swept: one int8 kernel here")
    ap.add_argument("--prepad", action="store_true",
                    help="accepted, not swept: the wrapper pads nothing")
    ap.add_argument("--n-rows", type=int, default=N_ROWS,
                    help="ref rows (the index shape by default)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' for the plain version")
    return ap


def sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def classes_of(refs: torch.Tensor, pack: int) -> int:
    """The kernel's ref-row classes for these stored refs."""
    n, rw = refs.shape
    return row_classes(rw, n, pack, refs.data_ptr() % 16 == 0)


def default_plan(b: int, n: int, k: int, pack: int, classes: int,
                 sms: int) -> tuple[int, int]:
    """``(rows, stages)`` that ``l2_topk_rf(plan=None)`` takes."""
    _, rows = split_plan(b, max(n, 1), sms, classes)
    return rows, ring_stages(list_stride(k), pack > 1)


def plan_grid(b: int, n: int, k: int, pack: int, classes: int, sms: int,
              rows: list[int] | None = None,
              stages: list[int] | None = None) -> list[tuple[int, int]]:
    """The plans to sweep, the default first: ``rows`` (default: the
    default's and x1/2, x2, x4, each rounded up to a multiple of 192) by
    ``stages`` (default: 1 ... the deepest ring that fits)."""
    base = default_plan(b, n, k, pack, classes, sms)
    if rows is None:
        rows = [base[0]] + [-(-int(base[0] * f) // _BN) * _BN
                            for f in (0.5, 2, 4)]
    if stages is None:
        stages = list(range(1, base[1] + 1))
    grid = [base] + [(r, s) for r in rows for s in stages]
    for plan in grid:
        check_plan(plan, k, pack)
    return list(dict.fromkeys(grid))


def describe(plan, b: int, n: int, classes: int, sms: int) -> dict:
    """The plan's splits and the waves its pass-1 grid takes (one block an
    SM: a block's ring and lists fill most of its shared memory)."""
    splits = plan_splits(max(n, 1), classes, plan[0])
    blocks = -(-b // _BQ) * splits
    return {"rows": plan[0], "splits": splits, "stages": plan[1],
            "waves": -(-blocks // sms)}


def oracle_ids(q: np.ndarray, refs: np.ndarray, k: int) -> np.ndarray:
    """The JAX tool's numpy oracle: ``|q|^2 - 2 q.r + |r|^2`` in float32
    and a stable argsort, the refs' rows ``ORACLE_CHUNK`` at a time."""
    q = q.astype(np.float32)
    qn = (q ** 2).sum(1)[:, None]
    dists = np.empty((q.shape[0], refs.shape[0]), np.float32)
    for s in range(0, refs.shape[0], ORACLE_CHUNK):
        r = refs[s:s + ORACLE_CHUNK].astype(np.float32)
        dists[:, s:s + len(r)] = qn - 2.0 * q @ r.T + (r ** 2).sum(1)[None, :]
    return np.argsort(dists, 1, kind="stable")[:, :k]


def make_data(args, device: torch.device):
    """``(bits [N, d] int8, index, queries [chunks, B, d] int8)``."""
    from ..index.flat import FlatL2Index

    gen = torch.Generator(device=device).manual_seed(0)
    bits = torch.randint(0, 2, (args.n_rows, D), generator=gen,
                         device=device, dtype=torch.int8)
    qs = torch.randint(0, 2, (args.chunks, args.batch, D), generator=gen,
                       device=device, dtype=torch.int8)
    if args.dtype == "packed":
        idx = FlatL2Index.build(bits, pack=8, device=device)
    else:
        idx = FlatL2Index.build(bits, dtype="int4" if args.dtype == "int4"
                                else torch.int8, device=device)
    return bits, idx, qs


def elapsed_ms(fn, cuda: bool) -> float:
    """Device time of ``fn()`` on the card (CUDA events), host time off
    it."""
    if not cuda:
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def sweep(idx, qs, k: int, plans, oracle: np.ndarray, sms: int
          ) -> list[dict]:
    """Check and time each plan (see the module docstring); the rows, in
    the order of ``plans``, whose first is the default."""
    pack = idx.pack
    chunks, b = qs.shape[:2]
    n = idx.vectors.shape[0]
    classes = classes_of(idx.vectors, pack)

    def search(q, plan):
        return l2_topk_rf(q, idx.vectors, idx.norms, k, pack=pack,
                             plan=plan)

    def run_all(plan):
        return [search(qs[c], plan) for c in range(chunks)]

    want = run_all(plans[0])
    rows = []
    for plan in plans:
        got = run_all(plan)            # also the warm-up
        same = all(torch.equal(gv, wv) and torch.equal(gi, wi)
                   for (gv, gi), (wv, wi) in zip(got, want))
        ids0 = got[0][1][:ORACLE_QUERIES].cpu().numpy()
        rows.append({**describe(plan, b, n, classes, sms),
                     "ids_equal_default": same,
                     "oracle_exact": bool((ids0 == oracle).all()),
                     "recall_ok": bool((ids0 == oracle).mean() > 0.999),
                     "ms_turns": []})
        del got
    order = list(range(len(plans))) + list(reversed(range(len(plans))))
    for i in order:
        rows[i]["ms_turns"].append(elapsed_ms(
            lambda p=plans[i]: run_all(p), qs.is_cuda) / chunks)
    for row in rows:
        ms = sum(row["ms_turns"]) / len(row["ms_turns"])
        row["ms_per_batch"] = ms
        row["qps"] = b / (ms / 1e3)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> list[dict]:
    from ..device import card_line, resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    for flag, value, why in (
            ("--compute", args.compute, "computed as int8 on Hopper"),
            ("--order", args.order, "one int8 kernel, l2_topk_rf"),
            ("--prepad", args.prepad, "the wrapper pads nothing")):
        print(f"{flag} {value}: not swept ({why})", file=sys.stderr)
    bits, idx, qs = make_data(args, device)
    pack = idx.pack
    sms = sm_count(device)
    classes = classes_of(idx.vectors, pack)
    rows_arg = None if args.rows is None else [
        int(x) for x in args.rows.split(",")]
    stages_arg = None if args.stages is None else [
        int(x) for x in args.stages.split(",")]
    plans = plan_grid(args.batch, args.n_rows, K, pack, classes, sms,
                      rows_arg, stages_arg)
    print(f"data ready: N={args.n_rows} d={D} stored "
          f"{list(idx.vectors.shape)} {idx.vectors.dtype} pack {pack}, "
          f"{classes} row class(es), {sms} SMs; {len(plans)} plans",
          file=sys.stderr, flush=True)
    t = time.perf_counter()
    oracle = oracle_ids(qs[0, :ORACLE_QUERIES].cpu().numpy(),
                        bits.cpu().numpy(), K)
    print(f"oracle on {ORACLE_QUERIES} queries: "
          f"{time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    del bits
    rows = sweep(idx, qs, K, plans, oracle, sms)
    ok = [r for r in rows if r["ids_equal_default"] and r["oracle_exact"]]
    best = max(ok, key=lambda r: r["qps"]) if ok else None
    print(json.dumps({"best": best}), flush=True)
    bad = [(r["rows"], r["stages"]) for r in rows if r not in ok]
    if bad:
        raise RuntimeError(f"plans {bad} disagree with the default plan or "
                           f"the oracle")
    return rows


if __name__ == "__main__":
    main()
