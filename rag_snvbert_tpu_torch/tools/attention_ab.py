"""Time two or more builds of the attention kernels in turns on one card.

Each ``--variant LABEL=DIR`` names a directory holding an ``attention.cu``
and an ``attention_bwd.cu`` with the package's C interface (for example
``csrc/`` of an unpacked ``git archive`` of another commit); the package's
own ``csrc/`` is always the variant ``this``.  The script builds every
variant with the package's nvcc flags (all at once), prints each build's
full ptxas report, checks each build against the plain versions at the
main paths' shapes (forward ``[64, 3, 1030, 128]``, backward
``[48, 3, 1030, 128]``, the tolerances of ``chip_smoke.py``; reruns
bit-identical), then times the forward and the backward of the variants in
turns (A, B, B, A for two), ``scaled_dot_product_attention`` forward and
forward+backward before and after them, and splits each backward by kernel
with ``torch.profiler``.  One CUDA device; run from the repository root:

    git archive HEAD~1 | tar -x -C build/parent
    python -m rag_snvbert_tpu_torch.tools.attention_ab \\
        --variant parent=build/parent/rag_snvbert_tpu_torch/csrc

The last line of the output is a JSON summary.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops.attention import (_BWD_SIGNATURES, _FWD_SIGNATURES,
                             attention_bwd_plain, attention_fwd_plain)

FWD_SHAPE = (64, 3, 1030, 128)
BWD_SHAPE = (48, 3, 1030, 128)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12
ATTN_TOL = 2 ** -6             # as chip_smoke.py
BWD_REL_TOL = 2 ** -6


def build_variants(variants: dict[str, Path]) -> dict[str, dict]:
    """``{label: {"attention": CDLL, "attention_bwd": CDLL}}``; one nvcc
    per source, all started together."""
    procs = []
    for label, csrc in variants.items():
        out = _build.BUILD_DIR / "ab" / label
        out.mkdir(parents=True, exist_ok=True)
        for name in ("attention", "attention_bwd"):
            so = out / f"lib{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                   str(so), str(csrc / f"{name}.cu")]
            procs.append((label, name, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs: dict[str, dict] = {label: {} for label in variants}
    for label, name, so, proc in procs:
        log, _ = proc.communicate()
        print(f"--- {label} {name}.cu: nvcc exit {proc.returncode}")
        print(log.strip())
        if proc.returncode != 0:
            sys.exit(f"build of {label} {name}.cu failed")
        lib = ctypes.CDLL(str(so))
        sigs = _FWD_SIGNATURES if name == "attention" else _BWD_SIGNATURES
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[label][name] = lib
    return libs


def fwd(lib, q, k, v, scale, with_lse=False):
    b, h, l, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, l, dtype=torch.float32, device=q.device) \
        if with_lse else None
    _build.check(lib.attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b * h, l, hd, float(scale),
        torch.cuda.current_stream().cuda_stream), "attention")
    return out, lse


def bwd(lib, q, k, v, o, lse, do, scale):
    b, h, l, hd = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dsum = torch.empty(b, h, l, dtype=torch.float32, device=q.device)
    _build.check(lib.attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dsum.data_ptr(), b * h, l, hd, float(scale),
        torch.cuda.current_stream().cuda_stream), "attention_bwd")
    return dq, dk, dv


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: float, flop: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S) * 1e3


def kernel_split(fn, calls: int = 10) -> dict[str, float]:
    """Mean device ms per call of each kernel that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times kernels on the card")
    import torch.nn.functional as F

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    variants = {lab: Path(d) for lab, d in
                (v.split("=", 1) for v in args.variant)}
    variants["this"] = _build.CSRC
    libs = build_variants(variants)
    labels = list(variants)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(shape, n):
        return [torch.randn(shape, generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(n)]

    # ---- forward ----
    q, k, v = inputs(FWD_SHAPE, 3)
    scale = FWD_SHAPE[-1] ** -0.5
    ref = attention_fwd_plain(q, k, v, scale)[0].float()
    for lab in labels:
        a = fwd(libs[lab]["attention"], q, k, v, scale)[0]
        b = fwd(libs[lab]["attention"], q, k, v, scale)[0]
        err = (a.float() - ref).abs().max().item()
        same = torch.equal(a, b)
        print(f"forward {lab}: max_abs_err {err:.3e} (tol {ATTN_TOL:.3e}), "
              f"rerun bit-identical {same}")
        if not (err <= ATTN_TOL and same):
            sys.exit(f"forward {lab} disagrees with the plain version")
    del ref, a, b
    order = labels + labels[::-1]
    sdpa = [time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), args.iters)]
    fwd_ms: dict[str, list] = {lab: [] for lab in labels}
    for lab in order:
        lib = libs[lab]["attention"]
        fwd_ms[lab].append(time_ms(lambda: fwd(lib, q, k, v, scale),
                                   args.iters))
    sdpa.append(time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), args.iters))
    b_, h, l, hd = FWD_SHAPE
    flop = 4 * b_ * h * l * l * hd
    f_bound = bound_ms(4 * b_ * h * l * hd * 2, flop)
    summary = {"card": card, "fwd": {}, "bwd": {},
               "fwd_shape": FWD_SHAPE, "bwd_shape": BWD_SHAPE,
               "fwd_bound_ms": f_bound, "sdpa_fwd_ms": sdpa}
    for lab in labels:
        m = statistics.mean(fwd_ms[lab])
        summary["fwd"][lab] = {"ms": fwd_ms[lab], "mean_ms": m,
                               "tflops": flop / m / 1e9,
                               "share_of_bound": f_bound / m,
                               "vs_sdpa": m / statistics.mean(sdpa)}
        print(f"forward {lab}: ms {[round(x, 4) for x in fwd_ms[lab]]} mean "
              f"{m:.4f}, {flop / m / 1e9:.1f} TFLOP/s, {f_bound / m:.1%} of "
              f"the {f_bound:.4f} ms bound, {m / statistics.mean(sdpa):.3f}x "
              f"SDPA")
    print(f"scaled_dot_product_attention forward: ms "
          f"{[round(x, 4) for x in sdpa]}")
    del q, k, v

    # ---- backward ----
    q, k, v, do = inputs(BWD_SHAPE, 4)
    scale = BWD_SHAPE[-1] ** -0.5
    this_fwd = libs["this"]["attention"]
    o, lse = fwd(this_fwd, q, k, v, scale, with_lse=True)
    want = [w.float() for w in attention_bwd_plain(
        *(x.float() for x in (q, k, v, o)), lse, do.float(), scale)]
    for lab in labels:
        lib = libs[lab]["attention_bwd"]
        got = bwd(lib, q, k, v, o, lse, do, scale)
        again = bwd(lib, q, k, v, o, lse, do, scale)
        errs = [(a.float() - w).abs().max().item() / w.abs().max().item()
                for a, w in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"backward {lab}: max_abs_err / max|ref| dq dk dv "
              f"{[f'{e:.2e}' for e in errs]} (tol {BWD_REL_TOL:.2e}), rerun "
              f"bit-identical {same}")
        if not (max(errs) <= BWD_REL_TOL and same):
            sys.exit(f"backward {lab} disagrees with the plain version")
    del want, got, again
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        torch.autograd.grad(out, leaves, do)

    def sdpa_bwd_ms():
        return time_ms(sdpa_fwd_bwd, args.iters) - time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            args.iters)

    sdpa_b = [sdpa_bwd_ms()]
    bwd_ms: dict[str, list] = {lab: [] for lab in labels}
    for lab in order:
        lib = libs[lab]["attention_bwd"]
        bwd_ms[lab].append(time_ms(
            lambda: bwd(lib, q, k, v, o, lse, do, scale), args.iters))
    sdpa_b.append(sdpa_bwd_ms())
    b_, h, l, hd = BWD_SHAPE
    flop = 10 * b_ * h * l * l * hd
    b_bound = bound_ms(8 * b_ * h * l * hd * 2 + b_ * h * l * 4, flop)
    summary.update(bwd_bound_ms=b_bound, sdpa_bwd_ms=sdpa_b)
    for lab in labels:
        m = statistics.mean(bwd_ms[lab])
        lib = libs[lab]["attention_bwd"]
        split = kernel_split(lambda: bwd(lib, q, k, v, o, lse, do, scale))
        summary["bwd"][lab] = {"ms": bwd_ms[lab], "mean_ms": m,
                               "tflops": flop / m / 1e9,
                               "share_of_bound": b_bound / m,
                               "vs_sdpa": m / statistics.mean(sdpa_b),
                               "by_kernel_ms": split}
        print(f"backward {lab}: ms {[round(x, 4) for x in bwd_ms[lab]]} mean "
              f"{m:.4f}, {flop / m / 1e9:.1f} TFLOP/s, {b_bound / m:.1%} of "
              f"the {b_bound:.4f} ms bound, {m / statistics.mean(sdpa_b):.3f}x"
              f" SDPA; by kernel "
              + ", ".join(f"{n} {t:.4f}" for n, t in split.items()))
    print(f"scaled_dot_product_attention backward (fwd+bwd minus fwd): ms "
          f"{[round(x, 4) for x in sdpa_b]}")
    print(card)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
