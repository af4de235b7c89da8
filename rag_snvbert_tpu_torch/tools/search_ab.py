"""Time two or more builds of the search kernels in turns on one card.

Each ``--variant LABEL=DIR`` names a copy of this package's directory (for
example ``rag_snvbert_tpu_torch/`` of an unpacked ``git archive`` of
another commit, or a copy with edited tile sizes): its
``csrc/l2_topk.cu``, ``csrc/l2_topk_rf.cu`` and ``csrc/l2_topk_float.cu``
are built with its own ``ops/_build.py`` and run through its own wrappers
``ops.l2_topk.l2_topk``, ``ops.l2_topk_rf.l2_topk_rf`` and
``ops.l2_topk_float.l2_topk_float``, whose Python signatures do not change
from commit to commit (their C interfaces and host-side plans may).  The
package that holds this file is always the variant ``this``.

For each kernel the script prints every variant's ptxas report, checks the
variant against the plain version (``l2_topk``: distances within 2e-4 of
the expansion's scale; ``l2_topk_rf`` and ``l2_topk_float`` on binary
genotypes: ids and distances exactly equal; ``l2_topk_float`` on Gaussian
float32: tie-aware within 1e-5 of the scale, and its float64 error beside
the plain float32 product's; reruns bit-identical), times the variants in
turns (A, B, B, A for two) with the library yardstick before and after them
(``matmul``+``topk``, in the refs' dtype with TF32 off; ``_int_mm``+``topk``),
splits one call of each variant by kernel with ``torch.profiler``, and times
the host side of one wrapper call.  Shapes:
``l2_topk`` q [64, 395520] x refs [2048, 395520] bf16, k = 1; ``l2_topk_rf``
the token search q [64, 1030] x refs [2048, 1040] and the genotype index
q [1024, 2040] x 664,648 rows at pack 8 and pack 1, k = 10; ``l2_topk_float``
the same index shape as binary genotypes in bf16 and float32 and as Gaussian
float32 (``chip_smoke.py``'s ``phase_l2_float`` inputs).  One CUDA
device; run from the repository root:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python -m rag_snvbert_tpu_torch.tools.search_ab \\
        --variant parent=build/parent/rag_snvbert_tpu_torch

``--only int8_probe`` times the int8 probe instead (it is not in the
default set): probe_mxu3's five cases (each variant with its own
``TPU_CASES`` tiles: the tiles' meaning may change between commits) and
probe_mxu's and probe_mxu2's ``256x128`` cases at d = 2040 (``rfirst``,
``qfirst``), each checked against the plain version (output and 64-bit
sum exactly), timed in turns, split by kernel (the int4 cases' pack apart,
and timed alone), with each variant's ptxas registers and spills per
instantiation.

``--only l2_topk``, ``--only l2_topk_rf`` or ``--only l2_topk_float`` runs
one kernel's part;
``--rows N`` cuts the index to N rows (a quick check); ``--no-check`` goes
on timing a variant that disagrees with the plain version (an experiment
that leaves a part of a kernel out to see what it costs).  The last line
of the output is a JSON summary.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..ops import l2_ref
from ..ops.l2_topk import l2_topk_plain
from ..ops.l2_topk_float import l2_topk_float_plain
from ..ops.l2_topk_rf import l2_topk_rf_plain
from ..ops.planar import pack_planar, planar_sq_norms
from .attention_ab import kernel_split, time_ms

L2_SHAPE = (64, 2048, 1030 * 384)      # B, N, d of the V18 serving search
L2_PAD_ROWS = 40
RF_TOKEN = (64, 2048, 1030)
RF_INDEX = (1024, 331 * 2008, 2040)
HBM_BYTES_PER_S = 3.35e12              # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
TF32_FLOP_PER_S = 495e12
L2_REL_TOL = 2e-4                      # as chip_smoke.py
FLOAT_REL_TOL = 1e-5                   # as chip_smoke.py
MUST_AGREE = True                      # --no-check clears it


def disagrees(what: str) -> None:
    if MUST_AGREE:
        sys.exit(f"{what} disagrees with the plain version")
    print(f"WARNING: {what} disagrees with the plain version")


def load_variant(label: str, pkg_dir: Path):
    """The package at ``pkg_dir`` imported under a name of its own, so that
    its relative imports reach its own modules (and its own ``csrc/``)."""
    if label == "this":
        name = __package__.rsplit(".", 1)[0]
    else:
        name = f"_search_ab_{label}"
        spec = importlib.util.spec_from_file_location(
            name, pkg_dir / "__init__.py",
            submodule_search_locations=[str(pkg_dir)])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    mods = {part: importlib.import_module(f"{name}.ops.{part}")
            for part in ("_build", "l2_topk", "l2_topk_rf", "l2_topk_float",
                         "int8_probe")}
    mods["probe_mxu3"] = importlib.import_module(f"{name}.tools.probe_mxu3")
    return mods


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds to enqueue one call (the queue is drained first
    and the calls are not waited for)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t
    torch.cuda.synchronize()
    return took / calls * 1e6


def in_turns(labels, make_fn, yardstick, iters: int) -> tuple[dict, list]:
    """Times of ``make_fn(label)`` for the labels forwards and backwards,
    the yardstick before and after."""
    lib = [time_ms(yardstick, iters)]
    ms: dict[str, list] = {lab: [] for lab in labels}
    for lab in labels + labels[::-1]:
        ms[lab].append(time_ms(make_fn(lab), iters))
    lib.append(time_ms(yardstick, iters))
    return ms, lib


def report(what, labels, ms, lib, lib_name, bound_ms, splits, hosts) -> dict:
    out = {"bound_ms": bound_ms, "library_ms": lib, "library": lib_name,
           "variants": {}}
    for lab in labels:
        m = statistics.mean(ms[lab])
        out["variants"][lab] = {
            "ms": ms[lab], "mean_ms": m, "share_of_bound": bound_ms / m,
            "vs_library": m / statistics.mean(lib),
            "by_kernel_ms": splits[lab], "host_us": hosts[lab]}
        print(f"{what} {lab}: ms {[round(x, 4) for x in ms[lab]]} mean "
              f"{m:.4f}, {bound_ms / m:.1%} of the {bound_ms:.4f} ms bound, "
              f"{m / statistics.mean(lib):.3f}x {lib_name}; host "
              f"{hosts[lab]:.1f} us a call; by kernel "
              + ", ".join(f"{n} {t:.4f}" for n, t in splits[lab].items()))
    print(f"{what} {lib_name}: ms {[round(x, 4) for x in lib]}")
    return out


def run_l2(mods, labels, iters, gen) -> dict:
    b, n, d = L2_SHAPE
    refs = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    pick = torch.randperm(n - L2_PAD_ROWS, generator=gen, device="cuda")[:b]
    noise = torch.randn(b, d, generator=gen, device="cuda")
    q = (refs[pick].float() + 0.5 * noise).to(torch.bfloat16)
    del noise
    norms = l2_ref.squared_norms(refs)
    norms[-L2_PAD_ROWS:] = float("inf")
    qn = l2_ref.squared_norms(q)
    full = l2_ref.l2_distances(q, refs, r_norms=norms)
    for k in (1, 8):
        rv, ri = l2_topk_plain(q, refs, norms, k)
        scale = qn[:, None] + norms[ri.long()]
        for lab in labels:
            fn = mods[lab]["l2_topk"].l2_topk
            vals, ids = fn(q, refs, norms, k)
            again = fn(q, refs, norms, k)
            rel = ((vals - rv).abs() / scale).max().item()
            tie = ((torch.gather(full, 1, ids.long()) - rv).abs()
                   / scale).max().item()
            same = torch.equal(vals, again[0]) and torch.equal(ids, again[1])
            print(f"l2_topk {lab} k={k}: max |err|/(|q|^2+|r|^2) {rel:.3e}, "
                  f"picked rows {tie:.3e} (tol {L2_REL_TOL:.0e}), ids equal "
                  f"{(ids == ri).float().mean().item():.4f}, rerun "
                  f"bit-identical {same}")
            if not (rel <= L2_REL_TOL and tie <= L2_REL_TOL and same):
                disagrees(f"l2_topk {lab}")
    del full

    def library():
        return torch.topk(qn[:, None] - 2.0 * torch.matmul(q, refs.T).float()
                          + norms[None], 1, dim=1, largest=False)

    def make(lab):
        fn = mods[lab]["l2_topk"].l2_topk
        return lambda: fn(q, refs, norms, 1)

    ms, lib = in_turns(labels, make, library, iters)
    bound_ms = max((b * d * 2 + n * d * 2 + n * 4 + b * 8) / HBM_BYTES_PER_S,
                   2 * b * n * d / BF16_FLOP_PER_S) * 1e3
    splits = {lab: kernel_split(make(lab)) for lab in labels}
    hosts = {lab: host_us(make(lab), 50) for lab in labels}
    return report(f"l2_topk q [{b}, {d}] refs [{n}, {d}] k=1", labels, ms,
                  lib, "matmul+topk", bound_ms, splits, hosts)


def run_rf_case(what, mods, labels, q, refs, norms, k, pack, d, lib_refs,
                iters) -> dict:
    rv, ri = l2_topk_rf_plain(q, refs, norms, k, pack=pack)
    for lab in labels:
        fn = mods[lab]["l2_topk_rf"].l2_topk_rf
        vals, ids = fn(q, refs, norms, k, pack=pack)
        again = fn(q, refs, norms, k, pack=pack)
        same = torch.equal(ids, ri) and torch.equal(vals, rv)
        rerun = torch.equal(vals, again[0]) and torch.equal(ids, again[1])
        print(f"{what} {lab}: ids and distances equal to plain {same}, "
              f"rerun bit-identical {rerun}")
        if not (same and rerun):
            disagrees(f"{what} {lab}")
    del rv, ri
    b, n = q.shape[0], refs.shape[0]
    qn = (q.to(torch.int32) ** 2).sum(1).float()

    def library():
        dots = torch._int_mm(q, lib_refs.t()).float()
        return torch.topk(qn[:, None] + norms[None] - 2.0 * dots, k, dim=1,
                          largest=False)

    def make(lab):
        fn = mods[lab]["l2_topk_rf"].l2_topk_rf
        return lambda: fn(q, refs, norms, k, pack=pack)

    ms, lib = in_turns(labels, make, library, iters)
    bound_ms = max((q.numel() + refs.numel() + 4 * n + 8 * b * k)
                   / HBM_BYTES_PER_S, 2 * b * n * d / INT8_OP_PER_S) * 1e3
    splits = {lab: kernel_split(make(lab)) for lab in labels}
    hosts = {lab: host_us(make(lab), 50 if n > 100000 else 500)
             for lab in labels}
    out = report(what, labels, ms, lib, "_int_mm+topk", bound_ms, splits,
                 hosts)
    out["int_mm_ms"] = time_ms(lambda: torch._int_mm(q, lib_refs.t()), iters)
    print(f"{what} torch._int_mm alone: {out['int_mm_ms']:.4f} ms")
    return out


def run_rf(mods, labels, iters, gen, rows) -> dict:
    out = {}
    b, n, d = RF_TOKEN
    width = -(-d // 16) * 16
    refs = torch.zeros(n, width, dtype=torch.int8, device="cuda")
    refs[: n - L2_PAD_ROWS, :d] = torch.randint(
        0, 7, (n - L2_PAD_ROWS, d), generator=gen, device="cuda",
        dtype=torch.int8)
    refs[1500:1510] = refs[:10]
    norms = (refs.to(torch.int32) ** 2).sum(1).float()
    norms[-L2_PAD_ROWS:] = float("inf")
    q = refs[torch.randperm(n - L2_PAD_ROWS, generator=gen,
                            device="cuda")[:b]].clone()
    q[:, 0:d:5] = 4
    # the wrappers take refs as wide as the queries (pack 1): the context's
    # padding columns are zero, so the queries are padded like it
    out["token"] = run_rf_case("l2_topk_rf token k=1", mods, labels, q, refs,
                               norms, 1, 1, d, refs, max(iters, 100))
    b, n, d = RF_INDEX
    n = rows or n
    bits = torch.randint(0, 2, (n, d), generator=gen, device="cuda",
                         dtype=torch.int8)
    qb = torch.randint(0, 2, (b, d), generator=gen, device="cuda",
                       dtype=torch.int8)
    packed = pack_planar(bits, 8)
    norms = planar_sq_norms(packed, 8)
    out["index_pack8"] = run_rf_case(
        f"l2_topk_rf index [{b}, {d}] x {n} pack=8 k=10", mods, labels, qb,
        packed, norms, 10, 8, d, bits, iters)
    del packed
    out["index_pack1"] = run_rf_case(
        f"l2_topk_rf index [{b}, {d}] x {n} pack=1 k=10", mods, labels, qb,
        bits, norms, 10, 1, d, bits, iters)
    return out


def float_check(what, q, refs, norms, got, want, exact) -> bool:
    """An ``l2_topk_float`` answer against the plain version's: equal on
    genotypes; else the same +inf slots, values within FLOAT_REL_TOL of
    |q|^2 + |r|^2, and where ids differ the float64 distances of both rows
    that close.  Prints the float64 error of both on non-exact data."""
    (v, i), (pv, pi) = got, want
    if exact:
        return torch.equal(i, pi) and torch.equal(v, pv)
    qd = q.to(refs.dtype).double()
    qn = (qd ** 2).sum(1)
    scale = qn[:, None] + norms.double()[pi.clamp_min(0).long()]
    rel = ((v.double() - pv.double()).abs() / scale).max().item()
    diff = i != pi
    tie = 0.0
    if diff.any():
        rows = qd[diff.nonzero()[:, 0]]
        d_k = ((rows - refs[i[diff].long()].double()) ** 2).sum(-1)
        d_p = ((rows - refs[pi[diff].long()].double()) ** 2).sum(-1)
        tie = ((d_k - d_p).abs() / scale[diff]).max().item()

    def f64_error(vals, ids):
        d64 = (qn[:, None] - 2.0 * torch.einsum(
            "bd,bkd->bk", qd, refs[ids.long()].double())
            + norms.double()[ids.long()])
        return ((vals.double() - d64).abs()
                / (qn[:, None] + norms.double()[ids.long()])).max().item()

    e_k, e_p = f64_error(v, i), f64_error(pv, pi)
    print(f"{what}: max |err|/(|q|^2+|r|^2) {rel:.3e}, ties {tie:.3e} (tol "
          f"{FLOAT_REL_TOL:.0e}); vs float64 kernel {e_k:.3e}, plain float32 "
          f"matmul {e_p:.3e}")
    return rel <= FLOAT_REL_TOL and tie <= FLOAT_REL_TOL and e_k <= e_p


def run_float_case(what, mods, labels, q, refs, norms, exact, iters) -> dict:
    k = 10
    want = l2_topk_float_plain(q, refs, norms, k)
    for lab in labels:
        fn = mods[lab]["l2_topk_float"].l2_topk_float
        got = fn(q, refs, norms, k)
        again = fn(q, refs, norms, k)
        rerun = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        ok = float_check(f"{what} {lab}", q, refs, norms, got, want, exact)
        print(f"{what} {lab}: agrees with plain {ok}, rerun bit-identical "
              f"{rerun}")
        if not (ok and rerun):
            disagrees(f"{what} {lab}")
        del got, again
    del want
    b, d = q.shape
    n = refs.shape[0]
    qc = q.to(refs.dtype)
    qn = (qc.float() ** 2).sum(1)

    def library():
        dots = torch.matmul(qc, refs.T).float()
        return torch.topk(qn[:, None] - 2.0 * dots + norms[None], k, dim=1,
                          largest=False)

    def make(lab):
        fn = mods[lab]["l2_topk_float"].l2_topk_float
        return lambda: fn(q, refs, norms, k)

    ms, lib = in_turns(labels, make, library, iters)
    size = refs.element_size()
    ops = 2 * b * n * d
    rate = BF16_FLOP_PER_S
    if refs.dtype == torch.float32:      # three TF32 products a pair
        ops, rate = 3 * ops, TF32_FLOP_PER_S
    bound_ms = max((size * (b * d + n * d) + 4 * n + 8 * b * k)
                   / HBM_BYTES_PER_S, ops / rate) * 1e3
    splits = {lab: kernel_split(make(lab)) for lab in labels}
    hosts = {lab: host_us(make(lab), 20) for lab in labels}
    return report(what, labels, ms, lib, "matmul+topk", bound_ms, splits,
                  hosts)


def run_float(mods, labels, iters, gen, rows) -> dict:
    b, n, d = RF_INDEX
    n = rows or n
    out = {}
    bits = torch.randint(0, 2, (n, d), generator=gen, device="cuda",
                         dtype=torch.int8)
    qb = torch.randint(0, 2, (b, d), generator=gen, device="cuda").float()
    norms = (bits.float() ** 2).sum(1)
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        refs = bits.to(dtype)
        out[f"genotypes_{name}"] = run_float_case(
            f"l2_topk_float index [{b}, {d}] x {n} {name} genotypes k=10",
            mods, labels, qb, refs, norms, True, iters)
        del refs
        torch.cuda.empty_cache()
    del bits
    refs = torch.randn(n, d, generator=gen, device="cuda")
    q = torch.randn(b, d, generator=gen, device="cuda")
    norms = (refs ** 2).sum(1)
    out["gaussian_f32"] = run_float_case(
        f"l2_topk_float index [{b}, {d}] x {n} f32 gaussian k=10", mods,
        labels, q, refs, norms, False, iters)
    return out


def run_probe(mods, labels, iters, gen) -> dict:
    """The int8 probe's cases (see the module docstring), at B = 1024, N =
    664,648 and d = 2048 (probe_mxu3) or 2040 (probe_mxu, probe_mxu2)."""
    from .probe_mxu import B, N, bound_ms as probe_bound_ms
    from .probe_mxu3 import D as D3, TQ as TQ3

    refs = torch.randint(0, 2, (N, D3), generator=gen, device="cuda",
                         dtype=torch.int8)
    refs_t = refs.t().contiguous()
    q = torch.randint(0, 2, (B, D3), generator=gen, device="cuda",
                      dtype=torch.int8)
    refs40 = torch.randint(0, 2, (N, 2040), generator=gen, device="cuda",
                           dtype=torch.int8)
    q40 = torch.randint(0, 2, (B, 2040), generator=gen, device="cuda",
                        dtype=torch.int8)
    # (case, q, refs, tq, tn, kwargs, tile of each variant or None)
    cases = []
    for i, case in enumerate(mods["this"]["probe_mxu3"].TPU_CASES):
        name, trans, int4, tn = case[:4]
        tiles = {lab: mods[lab]["probe_mxu3"].TPU_CASES[i][4]
                 for lab in labels}
        cases.append((name, q, refs_t if trans else refs, TQ3, tn,
                      {"trans": trans, "int4": int4, "running": True},
                      tiles))
    for order in ("rfirst", "qfirst"):
        cases.append((f"d2040_256x128_{order}", q40, refs40, 256, 512,
                      {"order": order}, None))
    out = {}
    for name, qc, rc, tq, tn, kw, tiles in cases:
        plain_kw = {k: v for k, v in kw.items() if k != "order"}
        want, want_total = mods["this"]["int8_probe"].int8_probe_plain(
            qc, rc, tq, tn, return_checksum=True, **plain_kw)

        def make(lab, checksum=True):
            fn = mods[lab]["int8_probe"].int8_probe
            extra = {"tile": tiles[lab]} if tiles else {}
            return lambda: fn(qc, rc, tq, tn, checksum=checksum, **kw,
                              **extra)

        for lab in labels:
            fn = mods[lab]["int8_probe"].int8_probe
            extra = {"tile": tiles[lab]} if tiles else {}
            got, total = fn(qc, rc, tq, tn, return_checksum=True, **kw,
                            **extra)
            same = torch.equal(got, want) and int(total) == int(want_total)
            print(f"int8_probe {name} {lab} tile {extra.get('tile')}: "
                  f"output and 64-bit sum equal to plain {same}")
            if not same:
                disagrees(f"int8_probe {name} {lab}")
            del got
        del want
        yard = make(labels[0])
        ms, lib = in_turns(labels, make, yard, iters)
        b, d = qc.shape
        n = rc.shape[1] if kw.get("trans") else rc.shape[0]
        bound = probe_bound_ms(b, n, d)
        splits = {lab: kernel_split(make(lab)) for lab in labels}
        hosts = {lab: host_us(make(lab), 20) for lab in labels}
        out[name] = report(f"int8_probe {name}", labels, ms, lib,
                           f"{labels[0]} again", bound, splits, hosts)
        if kw.get("int4"):
            src = rc
            pack = {lab: [] for lab in labels}
            for lab in labels + labels[::-1]:
                fn = mods[lab]["int8_probe"].pack_int4
                pack[lab].append(time_ms(
                    lambda: fn(src, trans=kw["trans"]), iters))
            for lab in labels:
                m = statistics.mean(pack[lab])
                out[name]["variants"][lab]["pack_ms"] = pack[lab]
                print(f"int8_probe {name} {lab}: pack alone ms "
                      f"{[round(x, 4) for x in pack[lab]]} mean {m:.4f} "
                      f"({(src.numel() * 1.5) / 3.35e12 * 1e3:.4f} ms "
                      "bound: read once, half written, at 3.35 TB/s)")
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--only", choices=("l2_topk", "l2_topk_rf",
                                       "l2_topk_float", "int8_probe"))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rows", type=int, default=0,
                    help="rows of the genotype index (default: all 664,648)")
    ap.add_argument("--no-check", action="store_true")
    args = ap.parse_args(argv)
    global MUST_AGREE
    MUST_AGREE = not args.no_check
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times kernels on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    variants = {lab: Path(d) for lab, d in
                (v.split("=", 1) for v in args.variant)}
    variants["this"] = Path(__file__).resolve().parent.parent
    mods = {lab: load_variant(lab, d) for lab, d in variants.items()}
    labels = list(variants)
    names = ([args.only] if args.only
             else ["l2_topk", "l2_topk_rf", "l2_topk_float"])
    for lab in labels:
        t = time.perf_counter()
        mods[lab]["_build"].build(names)
        print(f"--- {lab}: built {names} in {time.perf_counter() - t:.1f} s")
        for name in names:
            print(f"--- {lab} {name}.cu")
            print(mods[lab]["_build"].ptxas_log(name).strip())
            for kernel, regs, st, ld in mods[lab]["_build"].ptxas_entries(
                    name):
                print(f"ptxas {lab} {kernel}: {regs} registers, spills "
                      f"{st} / {ld} bytes")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary: dict = {"card": card}
    if "l2_topk" in names:
        summary["l2_topk"] = run_l2(mods, labels, args.iters, gen)
        torch.cuda.empty_cache()
    if "l2_topk_rf" in names:
        summary["l2_topk_rf"] = run_rf(mods, labels, args.iters, gen,
                                       args.rows)
        torch.cuda.empty_cache()
    if "l2_topk_float" in names:
        summary["l2_topk_float"] = run_float(mods, labels, args.iters, gen,
                                             args.rows)
    if "int8_probe" in names:
        summary["int8_probe"] = run_probe(mods, labels, args.iters, gen)
    print(card)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
