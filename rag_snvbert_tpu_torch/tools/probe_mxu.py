"""Probe: the int8 tensor-core rate of the card at the genotype index shape.

The port of tools/probe_mxu.py.  ``l2_topk_rf`` searches 1024 queries
against 664,648 binary vectors of d = 2040; this times the int8 products
of that search alone (``ops.int8_probe``: every product on wgmma, no top-k
epilogue, the last ref tile's 128 columns written out) and sets them
beside ``torch._int_mm``, the library's product, at the same shape.  Each
case is checked first: its output equal to the plain version's, and its
64-bit sum of every product equal to ``colsum(q) . colsum(refs)`` (so no
product was skipped).  One JSON line a case: ``variant``, ``ms``, ``TOPs``,
``pct_of_bound`` (of 2 B N D operations at 1,979 TOP/s), the kernel's CTA
tile and order.  A reading above the card's int8 peak is a fault of the
probe and raises.

Cases: ``xla_int8`` (``_int_mm``; it also writes the [B, N] int32
product, 2.72 GB: 0.81 ms of writes at 3.35 TB/s), ``xla_int4`` (no
PyTorch call computes int4 x int4: printed in words), the TPU probe's five
``pallas_mm_{tq}x{tn}x{td}`` cases (tq, tn, td decide only the output's
padding and columns here), every CTA tile the kernel is built with, and
the default case without its 64-bit sum (what that epilogue costs).

Run on the card: python -m rag_snvbert_tpu_torch.tools.probe_mxu
"""

from __future__ import annotations

import json

import torch

from ..ops import int8_probe as probe
from ..utils.benchmarking import steady_state_ms

B, N, D = 1024, 664648, 2040
PEAK_INT8 = 1979e12       # H100 SXM, dense int8 (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
OUT_BYTES = probe.OUT_COLS * 4
TPU_CASES = ((256, 512, 2048), (256, 1024, 2048), (512, 512, 2048),
             (256, 512, 1024), (128, 2048, 2048))


def need_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the int8 probes measure the card: no CUDA "
                           "device here")


def bernoulli(shape, seed: int) -> torch.Tensor:
    """Bernoulli(0.5) int8 on the card from a seeded generator."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 2, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def bound_ms(b: int, n: int, d: int) -> float:
    """The least time for the products: 2 b n d operations at the int8
    peak, or the operands read once at the memory rate, the larger."""
    return max(2 * b * n * d / PEAK_INT8,
               (b * d + n * d + b * OUT_BYTES) / HBM_BYTES_PER_S) * 1e3


def time_ms(fn) -> float:
    """Per-call ms by the two-point slope; three warm-up calls first, so
    that the caching allocator holds every block a call needs (a first
    cudaMalloc inside the short run made the slope negative)."""
    return steady_state_ms(fn, iters_lo=3, iters_hi=13,
                           warmup=3)["per_iter_ms"]


def row(variant: str, ms: float, b: int, n: int, d: int, **extra) -> dict:
    ops = 2 * b * n * d
    if ms <= 0 or ops / (ms * 1e-3) > PEAK_INT8:
        raise RuntimeError(f"{variant}: {ms} ms for {ops} int8 operations "
                           "is not above zero or is above the card's int8 "
                           "peak: the probe is at fault")
    return {"variant": variant, "ms": round(ms, 4),
            "TOPs": round(ops / ms / 1e9, 1),
            "pct_of_bound": round(100 * bound_ms(b, n, d) / ms, 1), **extra}


def kernel_case(variant: str, q, r, tq: int, tn: int, **kw) -> dict:
    """One kernel case: checked against the plain version, then timed
    (the plain version too: ``plain_ms``)."""
    plain_kw = {k: kw[k] for k in ("trans", "running", "int4") if k in kw}
    launches = probe.int8_probe.launches
    packs = probe.pack_int4.launches
    out, total = probe.int8_probe(q, r, tq, tn, return_checksum=True, **kw)
    want, want_total = probe.int8_probe_plain(q, r, tq, tn,
                                              return_checksum=True,
                                              **plain_kw)
    equal = torch.equal(out, want)
    err = (out.long() - want.long()).abs().max().item()
    if not equal or int(total) != int(want_total):
        raise RuntimeError(
            f"{variant}: output equal to the plain version {equal}, "
            f"checksum {int(total)} against colsum(q).colsum(r) "
            f"{int(want_total)}")
    del out, want
    ms = time_ms(lambda: probe.int8_probe(q, r, tq, tn, **kw))
    plain_ms = time_ms(lambda: probe.int8_probe_plain(
        q, r, tq, tn, return_checksum=True, **plain_kw))
    b = q.shape[0]
    n, d = (r.shape[1], r.shape[0]) if kw.get("trans") else r.shape
    mode = ("int4" if kw.get("int4") else "trans" if kw.get("trans")
            else "direct")
    tile = kw.get("tile") or probe.DEFAULT_TILE[mode]
    return row(variant, ms, b, n, d, cta_tile=f"{tile[0]}x{tile[1]}",
               kd=tile[2], order=kw.get("order", "rfirst"),
               checksum=int(total), max_abs_err=err,
               plain_ms=round(plain_ms, 4),
               launches=probe.int8_probe.launches - launches,
               pack_launches=probe.pack_int4.launches - packs)


def library_int8(q, refs, reduce: str) -> dict:
    """``torch._int_mm`` over the whole [B, N] product (mat2 column-major:
    ``refs.t()``), reduced as the TPU probe's XLA row was."""
    b, (n, d) = q.shape[0], refs.shape
    fn = {"slice": lambda: torch._int_mm(q, refs.t())[:, :probe.OUT_COLS],
          "sum": lambda: torch._int_mm(q, refs.t()).sum()}[reduce]
    ms = time_ms(fn)
    writes = 4 * b * n
    return row("xla_int8", ms, b, n, d, call="torch._int_mm",
               reduction="[:, :128]" if reduce == "slice" else ".sum()",
               note=f"writes the [{b}, {n}] int32 product: "
                    f"{writes / 1e9:.2f} GB, "
                    f"{writes / HBM_BYTES_PER_S * 1e3:.2f} ms of writes "
                    "at 3.35 TB/s")


def library_int4() -> dict:
    return {"variant": "xla_int4",
            "note": "no PyTorch call computes int4 x int4 products: "
                    "not timed"}


class Rows(list):
    """The rows of a run, each printed as one JSON line when it comes."""

    def add(self, r: dict) -> None:
        self.append(r)
        print(json.dumps(r), flush=True)


def run() -> list[dict]:
    need_card()
    refs = bernoulli((N, D), 0)
    q = bernoulli((B, D), 1)
    rows = Rows()
    rows.add(library_int8(q, refs, "slice"))
    rows.add(library_int4())
    for tq, tn, td in TPU_CASES:
        rows.add(kernel_case(f"pallas_mm_{tq}x{tn}x{td}", q, refs, tq, tn))
    for tile in probe.TILES["direct"]:
        rows.add(kernel_case(f"cta_{tile[0]}x{tile[1]}_kd{tile[2]}", q, refs,
                             256, 512, tile=tile))
    tq, tn, td = TPU_CASES[0]
    launches = probe.int8_probe.launches
    ms = time_ms(lambda: probe.int8_probe(q, refs, tq, tn, checksum=False))
    bm, bn, kd = probe.DEFAULT_TILE["direct"]
    rows.add(row(f"pallas_mm_{tq}x{tn}x{td}_no_checksum", ms, B, N, D,
                 cta_tile=f"{bm}x{bn}", kd=kd, order="rfirst",
                 launches=probe.int8_probe.launches - launches))
    return rows


def main() -> None:
    run()


if __name__ == "__main__":
    main()
