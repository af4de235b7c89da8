#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``rag_snvbert_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py              # what the checks need
    python3 chip_smoke.py --profile    # plus one request and one training
                                       # micro-step under torch.profiler

It builds the CUDA kernels from ``rag_snvbert_tpu_torch/csrc`` (one nvcc
per source, started together) and holds each kernel against its plain
PyTorch version at the main paths' shapes.  Then it drives ten paths
with seeded random weights or data, each with the launch counts set to 0
just before it and read just after:
  - the int8 probe tools (``python -m rag_snvbert_tpu_torch.tools.probe_mxu``,
    ``probe_mxu2``, ``probe_mxu3``): every case at the genotype index shape
    (1024 x 664,648 x 2040, and 2048), each checked against the plain
    version and by its 64-bit sum of every product, beside ``_int_mm``;
  - V18 serving and training at the full ``tpu_default`` width (384d, 12
    layers, 3 heads of 128, L = 1030, a 2048-row window context): two
    imputation requests through ``ImputationService`` (batch 32), and one
    epoch of ``Trainer.fit`` (batch 24, gradient accumulation 2: four
    micro-steps, two updates, validation, a checkpoint and a restore);
  - V17 token-space serving and training at the full ``v17_token_rag``
    width (192d, 10 layers, 6 heads, L = 1030, float32, the same context
    size): two requests (batch 32) and one epoch of ``Trainer.fit``
    (batch 16, no accumulation);
  - the offline index at the genotype-index shape (1024 queries of 2040
    columns against 664,648 rows, k = 10): packed (pack 8), int8, bf16 and
    float32 ``FlatL2Index`` searches and masked searches, save/load round
    trips, and a ``HammingIndex`` search;
  - ``tpu_default`` with ``int8_matmuls=True`` (every encoder projection an
    ``Int8Dense``): two requests and micro-steps in "fwd_bwd" and "fwd"
    beside the bf16 model with the same weights;
  - the command line at ``tpu_default`` over VCF files under
    ``runs/chip_smoke_cli/`` (gitignored): ``prepare-data``, one epoch of
    ``train`` (batch 24 x accumulation 2), ``infer`` of 64 half-missing
    targets, ``emit-vcf``, ``serve`` over JSON lines in a subprocess (two
    requests), and the HTTP front end over ``BatchingImputationService``
    (four concurrent requests, three of them merged, then the four one at
    a time); the imputed VCFs are read back;
  - checkpoint interop under ``runs/chip_smoke_interop/``: a reference
    state_dict at ``v18_embedding_rag`` width through ``convert-ckpt``,
    ``infer`` (its ``l2_topk`` ids held against the plain search), two
    service requests, ``export-ckpt`` and a reconversion (bit-identical),
    and two micro-steps of ``train --init-from``;
  - ``tools/run_convergence.py`` at ``tpu_default`` on a four-window
    calibrated panel under ``runs/chip_smoke_convergence/``: an epoch with
    ``--profile`` and one more through ``--resume``, the trace summarized;
and checks the answers and the launch counts of each path.  V18 serving
also writes window 0's index and serves that window from it.  It prints
one JSON line of per-kernel numbers, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line; so does a machine without CUDA or a directory without
the package.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call is
# the larger of its bytes over the memory rate and its operations over the
# tensor cores' rate for their type (bf16 or int8).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
TF32_FLOP_PER_S = 495e12

ATTN_SHAPE = (64, 3, 1030, 128)        # [2B, H, L, hd] at batch 32
BWD_SHAPE = (48, 3, 1030, 128)         # [2B, H, L, hd] at training batch 24
L2_B, L2_N, L2_D = 64, 2048, 1030 * 384
L2_B_TRAIN = 48                        # [2B] at the training batch of 24
L2_PAD_ROWS = 40
# Attention: the kernel rounds P to bf16 for the P.V product and writes O
# in bf16 (2^-8 relative); |O| stays below ~4 for unit-normal q, k, v.
ATTN_TOL = 2 ** -6
# L2: |q|^2 - 2 q.r + |r|^2 cancels terms of size |q|^2 + |r|^2 (~1e6 here),
# each a float32 sum of 395,520 products taken in another order on each
# side: errors are measured relative to that scale, eps * sqrt(d) ~ 4e-5.
L2_REL_TOL = 2e-4
# The converted model's searches (phase_interop) against the exact nearest
# rows: a pick may sit above the nearest by a few float32 ulps (2^-23 each)
# of that scale, the rounding of the kernel's float32 sums, and no more.
INTEROP_TIE_REL = 1e-6
# Serving vs the plain path on the card (no kernels; bf16 attention scores
# as the tpu_default einsum path has them): bf16 roundings 12 layers deep
# move imputed probabilities by ~1e-3 on average, ~1e-2 at most.
PROB_MEAN_TOL = 5e-3
PROB_MAX_TOL = 0.05
# Attention backward vs its plain version (float32 from the same bf16
# inputs, the kernel's own O and LSE): the kernel rounds P and dS to bf16
# as product operands and writes bf16 (2^-9 relative each), so each of
# dq, dk, dv holds to 2^-6 of its largest entry.  The LSE is float32 on
# both sides, summed in other orders: 1e-5 of its largest entry.
BWD_REL_TOL = 2 ** -6
LSE_REL_TOL = 1e-5
# Training, kernel path vs plain path on the card (same weights, same
# batch, dropout off; the plain path takes attention in float32 scores,
# the kernels' plain arithmetic, where the kernels round P and dS to bf16):
# bf16 roundings 12 layers deep.  The loss holds to 1e-3 relative; each
# parameter's gradient to 5% relative L2, measured against the larger of
# its own norm and 1e-3 of the whole gradient's (the key biases' gradients
# vanish in exact arithmetic, so both sides hold rounding noise there).
# Observed on an H100: loss 1.8e-5, worst gradient 7.3e-3.
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 0.05
TRAIN_DIR = "runs/chip_smoke_train"     # inside the checkout (.gitignore)
# l2_topk_rf: the token-serving search ([2B, L] masked token queries against
# a window context of 2008 haplotypes + 40 +inf padding rows) and the
# genotype-index point of the TPU rounds' bench (BENCH_r05.json: 331
# windows x 2008 haplotypes of binary vectors, d = 2040, 1024 queries).
RF_SERVE = (64, 2048, 1030)
RF_INDEX = (1024, 331 * 2008, 2040)
# Token serving and training: kernel path vs plain search path on the card.
# The search is exact on both, so the same rows come back and the rest of
# the forward runs the same kernels on the same inputs: probabilities to
# 1e-5; the loss to 1e-6 relative and each parameter's gradient to 1e-4
# relative L2 (the key biases' floor as above; cuDNN's convolution backward
# may sum in another order from call to call).
TOKEN_PROB_TOL = 1e-5
TOKEN_LOSS_TOL = 1e-6
TOKEN_GRAD_TOL = 1e-4
TOKEN_TRAIN_DIR = "runs/chip_smoke_token_train"
# l2_topk_float and the offline index: the genotype-index point (as RF_INDEX)
# and a ragged edge (B, d, N off every tile; the largest k).
FLOAT_INDEX = (1024, 331 * 2008, 2040)
FLOAT_EDGE = (3, 50001, 37, 128)
# Gaussian float32 / bf16 search vs its plain version: both sum d products
# in float32 in other orders and round the expansion |q|^2 - 2 q.r + |r|^2:
# values to 1e-5 of |q|^2 + |r|^2 (observed <= 4e-7), and where ids differ
# the float64 distances of both rows lie that close.  Binary genotypes make
# every distance an exact float32 integer: equal ids and values.
FLOAT_REL_TOL = 1e-5
INDEX_PREFIX = 131072      # rows of the indexes saved and loaded back
# The int8 probe (csrc/int8_probe.cu): every built configuration at ragged
# shapes (B, N, d off every tile; d = 2040 rows as two row classes, d = 70
# as eight) against its plain version, exactly, before the probe tools run
# their cases at the index shape.
PROBE_EDGE = ((300, 50004, 2040), (20, 1000, 70))
# int8_matmuls at tpu_default (phase_int8).  Imputed probabilities of the
# int8 model against the bf16 model with the same weights, over a request's
# imputed genotypes: int8 products round each activation to 1/127 of its
# row's scale, and twelve layers carry that on (first run on an H100: mean
# |dp| 1.64e-3, max 1.02e-2).  The bands are three and five times that:
# random weights give flat probabilities, trained ones may spread more.
INT8_PROB_MEAN_TOL = 5e-3
INT8_PROB_MAX_TOL = 5e-2
INT8_TRAIN_DIR = "runs/chip_smoke_int8_train"
# The cli phase: the train/infer/serve/emit-vcf verbs and the HTTP front end
# at tpu_default over files under CLI_DIR (inside the checkout, gitignored).
# An imputed VCF prints HDS to three decimals: half a unit of the third
# decimal, plus one float32 rounding of the native formatter's v * 1000.
CLI_DIR = "runs/chip_smoke_cli"
HDS_TOL = 5e-4 + 1e-6


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls."""
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


def kernel_ms(fn, calls: int = 5) -> dict[str, float]:
    """Mean device ms per call of each kernel that ``fn`` launches, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    def short(key: str) -> str:
        m = re.search(r"(\w+)\(", key.replace("(anonymous namespace)::", ""))
        return m.group(1) if m else key[:40]

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {short(e.key): e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def bound(bytes_moved: float, ops: float,
          op_rate: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rates(flop: float, ms: float, b_ms: float, lib_ms: float) -> str:
    """Achieved rate, share of the bound and the ratio to the library call
    of a kernel that takes ``ms`` for ``flop`` operations."""
    return (f"{flop / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of the bound, "
            f"{ms / lib_ms:.3f}x the library call")


def phase_attention(gen) -> dict:
    import torch.nn.functional as F

    from rag_snvbert_tpu_torch.ops.attention import attention, attention_plain

    q, k, v = (torch.randn(ATTN_SHAPE, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = ATTN_SHAPE[-1] ** -0.5
    out = attention(q, k, v, scale)
    torch.cuda.synchronize()
    ref = attention_plain(q, k, v, scale)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"attention {list(ATTN_SHAPE)} bf16: max_abs_err {err:.3e} "
          f"(tol {ATTN_TOL:.3e}), finite {bool(torch.isfinite(out).all())}")
    check(err <= ATTN_TOL and bool(torch.isfinite(out).all()),
          "attention kernel disagrees with its plain version")
    check(torch.equal(out, attention(q, k, v, scale)),
          "attention runs are not bit-identical")
    ms = time_ms(lambda: attention(q, k, v, scale), 20)
    plain_ms = time_ms(lambda: attention_plain(q, k, v, scale), 3, 1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), 20)
    b, h, l, hd = ATTN_SHAPE
    flop = 4 * b * h * l * l * hd
    b_ms, by = bound(4 * b * h * l * hd * 2, flop)
    print(f"attention: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {lib_ms:.4f} (scaled_dot_product_attention) "
          f"bound_ms {b_ms:.4f} ({by}); rerun bit-identical; "
          + rates(flop, ms, b_ms, lib_ms))
    return {"name": "attention", "route": "cuda",
            "source": "rag_snvbert_tpu_torch/csrc/attention.cu",
            "replaces": "rag_snvbert_tpu/models/transformer.py:99",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}


def phase_attention_bwd(gen) -> dict:
    import torch.nn.functional as F

    from rag_snvbert_tpu_torch.ops.attention import (
        attention_bwd, attention_bwd_plain, attention_fwd, attention_fwd_plain)

    q, k, v, do = (torch.randn(BWD_SHAPE, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = BWD_SHAPE[-1] ** -0.5
    out, lse = attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    _, ref_lse = attention_fwd_plain(q, k, v, scale)
    lse_err = (lse - ref_lse).abs().max().item()
    lse_tol = LSE_REL_TOL * ref_lse.abs().max().item()
    print(f"attention lse {list(BWD_SHAPE)}: max_abs_err {lse_err:.3e} "
          f"(tol {lse_tol:.3e})")
    check(lse_err <= lse_tol, "attention forward LSE disagrees with plain")
    out2, lse2 = attention_fwd(q, k, v, scale)
    check(torch.equal(out, out2) and torch.equal(lse, lse2),
          "attention forward runs with the LSE are not bit-identical")
    del out2, lse2
    got = attention_bwd(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    want = attention_bwd_plain(*(x.float() for x in (q, k, v, out)), lse,
                               do.float(), scale)
    max_err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = (a.float() - b).abs().max().item()
        ref = b.abs().max().item()
        max_err = max(max_err, err)
        ok = bool(torch.isfinite(a).all()) and err <= BWD_REL_TOL * ref
        print(f"attention_bwd {name}: max_abs_err {err:.3e}, max|ref| "
              f"{ref:.3e} (tol {BWD_REL_TOL * ref:.3e}), finite "
              f"{bool(torch.isfinite(a).all())}")
        check(ok, f"attention_bwd kernel disagrees with plain ({name})")
    again = attention_bwd(q, k, v, out, lse, do, scale)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "attention_bwd runs are not bit-identical")
    del want, again
    ms = time_ms(lambda: attention_bwd(q, k, v, out, lse, do, scale), 20)
    plain_ms = time_ms(lambda: attention_bwd_plain(q, k, v, out, lse, do,
                                                   scale), 3, 1)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, scale=scale)
        torch.autograd.grad(o, leaves, do)

    lib_ms = time_ms(sdpa_fwd_bwd, 20) - time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20)
    b, h, l, hd = BWD_SHAPE
    # q, k, v, o, dO in and dq, dk, dv out (bf16), the LSE in (fp32); the
    # five products of the function: 10 * BH * L^2 * hd.
    flop = 10 * b * h * l * l * hd
    b_ms, by = bound(8 * b * h * l * hd * 2 + b * h * l * 4, flop)
    print(f"attention_bwd: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {lib_ms:.4f} (scaled_dot_product_attention fwd+bwd "
          f"minus fwd) bound_ms {b_ms:.4f} ({by}); "
          + rates(flop, ms, b_ms, lib_ms))
    return {"name": "attention_bwd", "route": "cuda",
            "source": "rag_snvbert_tpu_torch/csrc/attention_bwd.cu",
            "replaces": "rag_snvbert_tpu/models/transformer.py:141",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}


def _tie_aware(name, vals, ids, ref_vals, ref_ids, scale, dist_of) -> float:
    """Values agree within L2_REL_TOL of the expansion's scale (|q|^2 +
    |r|^2 of the plain pick); where ids differ, the kernel's row has the
    plain distance of the plain pick (a near-tie).  Returns max |err|."""
    err = (vals - ref_vals).abs()
    rel = (err / scale).max().item()
    same = (ids == ref_ids).float().mean().item()
    diff = ids != ref_ids
    tie_rel = 0.0
    if diff.any():
        tie_rel = ((dist_of(ids) - ref_vals).abs() / scale)[diff].max().item()
    print(f"l2_topk {name}: ids equal {same:.6f}, max |err| "
          f"{err.max().item():.3e}, max |err|/(|q|^2+|r|^2) {rel:.3e}, "
          f"ties {tie_rel:.3e} (tol {L2_REL_TOL:.0e})")
    check(rel <= L2_REL_TOL and tie_rel <= L2_REL_TOL,
          f"l2_topk kernel disagrees with its plain version ({name})")
    return err.max().item()


def phase_l2(gen) -> dict:
    from rag_snvbert_tpu_torch.ops import l2_ref
    from rag_snvbert_tpu_torch.ops.l2_topk import l2_topk, l2_topk_plain

    refs = torch.randn(L2_N, L2_D, generator=gen, device="cuda").to(
        torch.bfloat16)
    pick = torch.randperm(L2_N - L2_PAD_ROWS, generator=gen,
                          device="cuda")[:L2_B]
    noise = torch.randn(L2_B, L2_D, generator=gen, device="cuda")
    q = (refs[pick].float() + 0.5 * noise).to(torch.bfloat16)
    del noise
    norms = l2_ref.squared_norms(refs)
    norms[-L2_PAD_ROWS:] = float("inf")
    qn = l2_ref.squared_norms(q)

    def dist_of(i):
        d = l2_ref.l2_distances(q, refs, r_norms=norms)
        return torch.gather(d, 1, i.long())

    max_err = 0.0
    for k in (1, 8, 128):
        vals, ids = l2_topk(q, refs, norms, k)
        torch.cuda.synchronize()
        rv, ri = l2_topk_plain(q, refs, norms, k)
        check(bool((ids < L2_N - L2_PAD_ROWS).all()),
              "l2_topk returned a padding row")
        scale = qn[:, None] + norms[ri.long()]
        max_err = max(max_err, _tie_aware(f"k={k}", vals, ids, rv, ri,
                                          scale, dist_of))
        again = l2_topk(q, refs, norms, k)
        check(torch.equal(again[0], vals) and torch.equal(again[1], ids),
              f"l2_topk runs are not bit-identical (k={k})")
        # the training batch's shape: the first 48 queries (gather takes
        # an index of fewer rows: dist_of serves them as it is)
        tv, ti = l2_topk(q[:L2_B_TRAIN].contiguous(), refs, norms, k)
        torch.cuda.synchronize()
        max_err = max(max_err, _tie_aware(
            f"B={L2_B_TRAIN} k={k}", tv, ti, rv[:L2_B_TRAIN],
            ri[:L2_B_TRAIN], scale[:L2_B_TRAIN], dist_of))
        if k == 1:
            check(bool((ids[:, 0] == pick.int()).all()),
                  "l2_topk missed a planted nearest row")
            # float64 truth of the planted pairs: which side is closer
            d64 = ((q.double() - refs[pick].double()) ** 2).sum(-1)
            e_k = ((vals[:, 0].double() - d64).abs() / scale[:, 0]).max()
            e_p = ((rv[:, 0].double() - d64).abs() / scale[:, 0]).max()
            print(f"l2_topk k=1 vs float64: kernel {e_k.item():.3e}, "
                  f"plain {e_p.item():.3e} (relative to |q|^2+|r|^2)")
            check(e_k.item() <= L2_REL_TOL, "l2_topk far from float64")
    ms = time_ms(lambda: l2_topk(q, refs, norms, 1), 10)
    plain_ms = time_ms(lambda: l2_topk_plain(q, refs, norms, 1), 2, 1)
    lib_ms = time_ms(lambda: torch.topk(
        qn[:, None] - 2.0 * torch.matmul(q, refs.T).float() + norms[None],
        1, dim=1, largest=False), 10)
    b_ms, by = bound(L2_B * L2_D * 2 + L2_N * L2_D * 2 + L2_N * 4
                     + L2_B * 8, 2 * L2_B * L2_N * L2_D)
    print(f"l2_topk q [{L2_B}, {L2_D}] refs [{L2_N}, {L2_D}] bf16 k=1: "
          f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{lib_ms:.4f} (matmul+topk) bound_ms {b_ms:.4f} ({by}); reruns "
          f"bit-identical; B = {L2_B} and {L2_B_TRAIN}")
    print("l2_topk device ms by kernel: " + ", ".join(
        f"{n} {t:.4f}" for n, t in kernel_ms(
            lambda: l2_topk(q, refs, norms, 1)).items()))

    # Constructed exact ties: rows 1000..1009 duplicate rows 0..9 and the
    # queries equal rows 0..9, so each query's two nearest rows tie exactly
    # and the lower id must come first.
    refs[1000:1010] = refs[:10]
    norms[1000:1010] = norms[:10]
    tq = refs[:10].clone()
    _, ids = l2_topk(tq, refs, norms, 2)
    want = torch.stack([torch.arange(10), torch.arange(1000, 1010)], 1)
    check(torch.equal(ids.cpu().long(), want),
          f"l2_topk tie order wrong: {ids.cpu().tolist()}")
    print("l2_topk constructed ties: ids ascending on equal distances")
    return {"name": "l2_topk", "route": "cuda",
            "source": "rag_snvbert_tpu_torch/csrc/l2_topk.cu",
            "replaces": "rag_snvbert_tpu/ops/l2_topk_pallas.py:203",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}


def _rf_case(name, q, refs, norms, k, pack, d, lib_refs, iters) -> dict:
    """l2_topk_rf against its plain version (ids and distances exactly
    equal, reruns bit-identical), then timed beside the plain version and
    the library yardstick: ``torch._int_mm`` over the unpacked int8 refs,
    the norms, and ``torch.topk``."""
    from rag_snvbert_tpu_torch.ops.l2_topk_rf import (l2_topk_rf,
                                                      l2_topk_rf_plain)

    vals, ids = l2_topk_rf(q, refs, norms, k, pack=pack)
    torch.cuda.synchronize()
    rv, ri = l2_topk_rf_plain(q, refs, norms, k, pack=pack)
    same = torch.equal(ids, ri) and torch.equal(vals, rv)
    fin = torch.isfinite(rv)
    err = (vals[fin] - rv[fin]).abs().max().item() if fin.any() else 0.0
    again = l2_topk_rf(q, refs, norms, k, pack=pack)
    rerun = torch.equal(again[0], vals) and torch.equal(again[1], ids)
    print(f"l2_topk_rf {name}: ids and distances equal to plain {same}, "
          f"max_abs_err {err}, rerun bit-identical {rerun}")
    check(same and rerun, f"l2_topk_rf disagrees with its plain version "
          f"({name})")
    del again, rv, ri
    b, n = q.shape[0], refs.shape[0]
    qn = (q.to(torch.int32) ** 2).sum(1).float()

    def library():
        dots = torch._int_mm(q, lib_refs.t()).float()
        return torch.topk(qn[:, None] + norms[None] - 2.0 * dots, k, dim=1,
                          largest=False)

    ms = time_ms(lambda: l2_topk_rf(q, refs, norms, k, pack=pack), iters)
    plain_ms = time_ms(lambda: l2_topk_rf_plain(q, refs, norms, k,
                                                pack=pack), 2, 1)
    lib_ms = time_ms(library, iters)
    # each input read once (refs as stored: packed bytes at pack 8), the
    # outputs written once; 2 operations per query x row x column of d
    b_ms, by = bound(q.numel() + refs.numel() + 4 * n + 8 * b * k,
                     2 * b * n * d, INT8_OP_PER_S)
    print(f"l2_topk_rf {name}: q {list(q.shape)} refs {list(refs.shape)} "
          f"int8 pack {pack} k={k}: kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {lib_ms:.4f} (_int_mm+norms+topk "
          f"over unpacked refs) bound_ms {b_ms:.4f} ({by})")
    print(f"l2_topk_rf {name} device ms by kernel: " + ", ".join(
        f"{n} {t:.4f}" for n, t in kernel_ms(
            lambda: l2_topk_rf(q, refs, norms, k, pack=pack)).items()))
    return {"shape": name, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def phase_l2_rf(gen) -> dict:
    from rag_snvbert_tpu_torch.ops.planar import pack_planar, planar_sq_norms

    # (a) token serving: token ids 0-6 (specials, alleles), the context's
    # int8 operand padded to 1040 columns as build_token_window_ctx pads
    # it, 40 +inf padding rows, duplicated rows (exact ties).
    b, n, d = RF_SERVE
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
    q[:, 0:d:5] = 4                            # masked sites
    cases = [_rf_case(f"token serving k={k}", q, refs, norms, k, 1, d, refs,
                      50) for k in (1, 10)]
    # (b), (c): the genotype index, binary vectors, planar-packed (pack 8,
    # [N, 256] bytes) and unpacked ([N, 2040] int8)
    b, n, d = RF_INDEX
    bits = torch.randint(0, 2, (n, d), generator=gen, device="cuda",
                         dtype=torch.int8)
    qb = torch.randint(0, 2, (b, d), generator=gen, device="cuda",
                       dtype=torch.int8)
    packed = pack_planar(bits, 8)
    norms = planar_sq_norms(packed, 8)
    cases.append(_rf_case("index pack=8", qb, packed, norms, 10, 8, d, bits,
                          10))
    del packed
    cases.append(_rf_case("index pack=1", qb, bits, norms, 10, 1, d, bits,
                          10))
    # the product's share of the yardstick: it also writes the [1024,
    # 664648] int32 matrix that a fused kernel never does
    mm_ms = time_ms(lambda: torch._int_mm(qb, bits.t()), 10)
    print(f"l2_topk_rf index: torch._int_mm alone {mm_ms:.4f} ms")
    main = cases[0]
    return {"name": "l2_topk_rf", "route": "cuda",
            "source": "rag_snvbert_tpu_torch/csrc/l2_topk_rf.cu",
            "replaces": "rag_snvbert_tpu/ops/l2_topk_pallas.py:356",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "by_shape": cases}


def _float_pair_check(name, q, refs, norms, got, want, exact) -> float:
    """l2_topk_float's answer against the plain version's: equal where the
    distances are exact integers, else tie-aware within FLOAT_REL_TOL of
    |q|^2 + |r|^2.  Returns max |err|."""
    (vals, ids), (rv, ri) = got, want
    if exact:
        same = torch.equal(ids, ri) and torch.equal(vals, rv)
        print(f"l2_topk_float {name}: ids and distances equal to plain "
              f"{same}")
        check(same, f"l2_topk_float disagrees with its plain version "
              f"({name})")
        return 0.0
    inf = torch.isinf(rv)
    check(torch.equal(torch.isinf(vals), inf)
          and torch.equal(ids[inf], ri[inf]),
          f"l2_topk_float +inf slots differ ({name})")
    qn = (q.to(refs.dtype).double() ** 2).sum(1)
    scale = qn[:, None] + norms.double()[ri.clamp_min(0).long()]
    fin = ~inf
    err = (vals.double() - rv.double()).abs()
    rel = (err / scale)[fin].max().item() if fin.any() else 0.0
    diff = (ids != ri) & fin
    tie = 0.0
    if diff.any():
        rows = diff.nonzero()[:, 0]
        qd = q.to(refs.dtype).double()[rows]
        d_k = ((qd - refs[ids[diff].long()].double()) ** 2).sum(-1)
        d_p = ((qd - refs[ri[diff].long()].double()) ** 2).sum(-1)
        tie = ((d_k - d_p).abs() / scale[diff]).max().item()
    print(f"l2_topk_float {name}: ids equal "
          f"{(ids == ri).float().mean().item():.6f}, max |err|/(|q|^2+|r|^2) "
          f"{rel:.3e}, ties {tie:.3e} (tol {FLOAT_REL_TOL:.0e})")
    check(rel <= FLOAT_REL_TOL and tie <= FLOAT_REL_TOL,
          f"l2_topk_float disagrees with its plain version ({name})")
    return err[fin].max().item() if fin.any() else 0.0


def _f64_error(q, refs, norms, vals, ids) -> float:
    """Max |returned distance - the same function in float64| of the
    returned pairs, relative to |q|^2 + |r|^2: |q|^2 - 2 q.r + |r|^2 with
    |q|^2 and q.r in float64 and the given |r|^2 (an input: its own float32
    rounding is not the search's error)."""
    qd = q.to(refs.dtype).double()
    rows = refs[ids.long()].double()                    # [B, k, d]
    qn = (qd ** 2).sum(1)[:, None]
    rn = norms.double()[ids.long()]
    d64 = qn - 2.0 * (qd[:, None, :] * rows).sum(-1) + rn
    return ((vals.double() - d64).abs() / (qn + rn)).max().item()


def _float_case(name, q, refs, norms, k, exact, iters) -> dict:
    """l2_topk_float at one shape: against the plain version, the float64
    error of both, reruns, and times beside the plain version and the
    library yardstick (one matmul in the refs' dtype, TF32 off, + topk)."""
    from rag_snvbert_tpu_torch.ops.l2_topk_float import (l2_topk_float,
                                                         l2_topk_float_plain)

    got = l2_topk_float(q, refs, norms, k)
    torch.cuda.synchronize()
    want = l2_topk_float_plain(q, refs, norms, k)
    err = _float_pair_check(name, q, refs, norms, got, want, exact)
    again = l2_topk_float(q, refs, norms, k)
    check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
          f"l2_topk_float runs are not bit-identical ({name})")
    out = {"shape": name, "max_abs_err": err}
    if not exact:
        e_k = _f64_error(q, refs, norms, *got)
        e_p = _f64_error(q, refs, norms, *want)
        print(f"l2_topk_float {name} vs float64 (relative to |q|^2+|r|^2): "
              f"kernel {e_k:.3e}, plain float32 matmul {e_p:.3e}")
        if refs.dtype == torch.float32:    # what Precision.HIGHEST asks
            check(e_k <= e_p, f"l2_topk_float is further from float64 than "
                  f"the plain float32 product ({name})")
        out.update(f64_err=e_k, plain_f64_err=e_p)
    del again, want
    if not iters:
        return out
    b, d = q.shape
    n = refs.shape[0]
    qc = q.to(refs.dtype)
    qn = (qc.float() ** 2).sum(1)

    def library():
        dots = torch.matmul(qc, refs.T).float()
        return torch.topk(qn[:, None] - 2.0 * dots + norms[None], k, dim=1,
                          largest=False)

    ms = time_ms(lambda: l2_topk_float(q, refs, norms, k), iters)
    plain_ms = time_ms(lambda: l2_topk_float_plain(q, refs, norms, k), 1, 1)
    lib_ms = time_ms(library, iters)
    size = refs.element_size()
    ops_ = 2 * b * n * d
    if refs.dtype == torch.float32:     # three TF32 products a pair
        b_ms, by = bound(size * (b * d + n * d) + 4 * n + 8 * b * k,
                         3 * ops_, TF32_FLOP_PER_S)
    else:
        b_ms, by = bound(size * (b * d + n * d) + 4 * n + 8 * b * k, ops_)
    print(f"l2_topk_float {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {lib_ms:.4f} (matmul in {str(refs.dtype)[6:]} + topk) "
          f"bound_ms {b_ms:.4f} ({by}); " + rates(ops_, ms, b_ms, lib_ms))
    print(f"l2_topk_float {name} device ms by kernel: " + ", ".join(
        f"{kn} {t:.4f}" for kn, t in kernel_ms(
            lambda: l2_topk_float(q, refs, norms, k), 3).items()))
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms)
    return out


def phase_l2_float(gen) -> dict:
    """l2_topk_float at the genotype-index shape: binary genotypes stored
    as bf16 and as float32 (exact), Gaussian float32 (a non-integer distance
    scale: the float64 error), and the ragged edge in both dtypes."""
    b, n, d = FLOAT_INDEX
    bits = torch.randint(0, 2, (n, d), generator=gen, device="cuda",
                         dtype=torch.int8)
    qb = torch.randint(0, 2, (b, d), generator=gen, device="cuda").float()
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        refs = bits.to(dtype)
        norms = (bits.float() ** 2).sum(1)
        cases.append(_float_case(f"index {str(dtype)[6:]} genotypes", qb,
                                 refs, norms, 10, True, 5))
        del refs
        torch.cuda.empty_cache()
    del bits
    refs = torch.randn(n, d, generator=gen, device="cuda")
    q = torch.randn(b, d, generator=gen, device="cuda")
    norms = (refs ** 2).sum(1)
    cases.append(_float_case("index float32 gaussian", q, refs, norms, 10,
                             False, 5))
    del refs, norms
    torch.cuda.empty_cache()
    eb, en, ed, ek = FLOAT_EDGE
    for dtype in (torch.float32, torch.bfloat16):
        refs = torch.randn(en, ed, generator=gen, device="cuda").to(dtype)
        norms = (refs.float() ** 2).sum(1)
        norms[[7, en - 1]] = float("inf")
        q = torch.randn(eb, ed, generator=gen, device="cuda")
        cases.append(_float_case(
            f"edge B={eb} N={en} d={ed} k={ek} {str(dtype)[6:]}", q, refs,
            norms, ek, False, 0))
    main = cases[0]
    return {"name": "l2_topk_float", "route": "cuda",
            "source": "rag_snvbert_tpu_torch/csrc/l2_topk_float.cu",
            "replaces": "rag_snvbert_tpu/ops/l2_topk_pallas.py:203",
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "by_shape": cases}


def _index_search(name, idx, q, mask, want_kernel):
    """search and masked_search through the index (its size rule picks the
    kernel) against use_pallas=False (no launch), exactly (genotypes)."""
    from rag_snvbert_tpu_torch import ops

    for what, fn in (("search", lambda **kw: idx.search(q, 10, **kw)),
                     ("masked_search",
                      lambda **kw: idx.masked_search(q, mask, 10, **kw))):
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        after = ops.launch_counts()
        launched = {k: v - before[k] for k, v in after.items()
                    if v != before[k]}
        plain = fn(use_pallas=False)
        check(ops.launch_counts() == after,
              "use_pallas=False launched a kernel")
        same = torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
        print(f"index {name} {what}: {sec * 1e3:.2f} ms (host clock, one "
              f"call), launches {launched}, equal to use_pallas=False {same}")
        check(launched == {want_kernel: 1},
              f"index {name} {what} did not launch {want_kernel}")
        check(same, f"index {name} {what} disagrees with the plain path")
        del got, plain


def phase_index(gen) -> dict[str, int]:
    """The offline index at the genotype-index shape through FlatL2Index,
    one storage at a time (each freed after use): packed (pack 8), int8,
    bf16 and float32, then a HammingIndex."""
    import tempfile

    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.index import FlatL2Index, HammingIndex

    b, n, d = FLOAT_INDEX
    bits = torch.randint(0, 2, (n, d), generator=gen, device="cuda",
                         dtype=torch.int8)
    q = torch.randint(0, 2, (b, d), generator=gen, device="cuda").float()
    mask = torch.rand(d, generator=gen, device="cuda") > 0.3
    ops.reset_launches()
    storages = (("packed", dict(pack=8), "l2_topk_rf"),
                ("int8", dict(dtype=torch.int8), "l2_topk_rf"),
                ("bf16", dict(dtype=torch.bfloat16), "l2_topk_float"),
                ("f32", dict(dtype=torch.float32), "l2_topk_float"))
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw, kernel in storages:
            src = bits if "pack" in kw else bits.float()
            torch.cuda.synchronize()
            t = time.perf_counter()
            idx = FlatL2Index.build(src, align=True, **kw)
            torch.cuda.synchronize()
            gb = idx.vectors.numel() * idx.vectors.element_size() / 1e9
            print(f"index {name}: build {time.perf_counter() - t:.2f} s, "
                  f"vectors {list(idx.vectors.shape)} {idx.vectors.dtype}, "
                  f"{gb:.2f} GB")
            _index_search(name, idx, q, mask, kernel)
            del idx
            # save/load round trip of the first INDEX_PREFIX rows
            part = FlatL2Index.build(src[:INDEX_PREFIX], align=True, **kw)
            path = os.path.join(tmp, name)
            part.save(path)
            back = FlatL2Index.load(path + ".npz")
            same = all(torch.equal(getattr(part, f), getattr(back, f))
                       for f in ("vectors", "norms")) and \
                (part.n_real, part.d_real, part.pack) == \
                (back.n_real, back.d_real, back.pack)
            a, c = part.search(q, 10), back.search(q, 10)
            same = same and torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
            print(f"index {name}: save/load of {INDEX_PREFIX} rows "
                  f"round-trips exactly {same}")
            check(same, f"index {name} save/load round trip")
            del part, back, src, a, c
            torch.cuda.empty_cache()
    counts = ops.launch_counts()
    # Hamming over the first rows: equal to its direct path and, on 0/1
    # data, to the packed L2 search (squared L2 is Hamming on bits)
    rows = bits[:65536].cpu().numpy()
    ham = HammingIndex.build(rows)
    qh = q[:64].to(torch.int8)
    streamed = ham.search(qh, 10, streaming=True)
    direct = ham.search(qh, 10, streaming=False)
    l2 = FlatL2Index.build(bits[:65536], pack=8).search(qh, 10,
                                                         use_pallas=False)
    same = torch.equal(streamed[0], direct[0]) and \
        torch.equal(streamed[1], direct[1]) and \
        torch.equal(direct[1], l2[1]) and \
        torch.equal(direct[0].float(), l2[0])
    print(f"hamming [64] x [65536, {d}] bits: streaming equal to direct and "
          f"to packed L2 {same}")
    check(same, "HammingIndex disagrees with its direct path or with L2")
    del bits
    want = {"attention": 0, "attention_bwd": 0, "l2_topk": 0,
            "l2_topk_rf": 2 * 4, "l2_topk_float": 2 * 4}
    print(f"index launches {counts} (expected {want}: search, masked "
          f"search and the round trip's two searches, two storages each)")
    check(counts == want, "the index path did not go through its kernels")
    return counts


def _probe_edges(gen) -> float:
    """Every configuration of csrc/int8_probe.cu at the ragged shapes of
    PROBE_EDGE against the plain version: output and 64-bit sum exactly
    equal.  Returns the largest absolute difference (0)."""
    from rag_snvbert_tpu_torch.ops import int8_probe as probe

    worst = 0
    for b, n, d in PROBE_EDGE:
        q = torch.randint(-128, 128, (b, d), generator=gen, device="cuda",
                          dtype=torch.int8)
        r = torch.randint(-128, 128, (n, d), generator=gen, device="cuda",
                          dtype=torch.int8)
        rt = r.t().contiguous()
        for mode, tiles in probe.TILES.items():
            for tile in tiles:
                for order in ("rfirst", "qfirst") if mode == "direct" \
                        else ("rfirst",):
                    kw = {"trans": mode == "trans", "int4": mode == "int4",
                          "running": mode != "direct"}
                    src = rt if kw["trans"] else r
                    out, total = probe.int8_probe(
                        q, src, 8, 128, tile=tile, order=order,
                        return_checksum=True, **kw)
                    want, want_total = probe.int8_probe_plain(
                        q, src, 8, 128, return_checksum=True, **kw)
                    err = (out.long() - want.long()).abs().max().item()
                    worst = max(worst, err)
                    check(err == 0 and int(total) == int(want_total),
                          f"int8_probe {mode} {tile} {order} at {(b, n, d)}:"
                          f" max_abs_err {err}, sum {int(total)} vs "
                          f"{int(want_total)}")
    print(f"int8_probe: {sum(len(t) for t in probe.TILES.values()) + 8} "
          f"configurations x orders at {PROBE_EDGE}: outputs and 64-bit sums "
          f"equal to the plain version")
    return float(worst)


def phase_probe_mxu(gen) -> tuple[dict, dict[str, int]]:
    """The int8 probe's path: the three probe tools (python -m
    rag_snvbert_tpu_torch.tools.probe_mxu{,2,3}) run every case at the
    index shape, each checked against the plain version and by its 64-bit
    sum inside the tool."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.tools import probe_mxu, probe_mxu2, probe_mxu3

    edge_err = _probe_edges(gen)
    torch.cuda.empty_cache()
    ops.reset_launches()
    rows = {}
    for name, tool in (("probe_mxu", probe_mxu), ("probe_mxu2", probe_mxu2),
                       ("probe_mxu3", probe_mxu3)):
        t = time.perf_counter()
        rows[name] = tool.run()
        torch.cuda.empty_cache()
        print(f"{name}: {len(rows[name])} cases, "
              f"{sum(r.get('launches', 0) for r in rows[name])} int8_probe "
              f"launches, {time.perf_counter() - t:.1f} s")
    counts = ops.launch_counts(tools=True)
    cases = [r for rs in rows.values() for r in rs if "launches" in r]
    want = {**{k: 0 for k in counts}, "int8_probe": sum(r["launches"]
                                                         for r in cases)}
    print(f"probe launches {counts} (expected {want})")
    check(counts == want and all(r["launches"] > 0 for r in cases),
          "the probe tools did not go through int8_probe")
    main = next(r for r in rows["probe_mxu"]
                if r["variant"] == "pallas_mm_256x512x2048")
    lib = next(r for r in rows["probe_mxu"] if r["variant"] == "xla_int8")
    from rag_snvbert_tpu_torch.tools.probe_mxu import B, D, N, bound_ms

    b_ms = bound_ms(B, N, D)
    print(f"int8_probe index shape [{B}, {D}] x [{N}, {D}]: kernel_ms "
          f"{main['ms']} ({main['cta_tile']}, kd {main['kd']}, rfirst) "
          f"plain_ms {main['plain_ms']} library_ms {lib['ms']} (_int_mm) "
          f"bound_ms {b_ms:.4f} (operations): {main['TOPs']} TOP/s, "
          f"{b_ms / main['ms']:.1%} of the bound, "
          f"{main['ms'] / lib['ms']:.3f}x the library call")
    keep = ("variant", "ms", "TOPs", "pct_of_bound", "cta_tile", "kd",
            "order", "plain_ms", "pack_ms", "note")
    entry = {"name": "int8_probe", "route": "cuda",
             "source": "rag_snvbert_tpu_torch/csrc/int8_probe.cu",
             "replaces": "tools/probe_mxu.py:34",
             "also_replaces": ["tools/probe_mxu2.py:33",
                               "tools/probe_mxu3.py:38"],
             "max_abs_err": max([edge_err] + [float(r["max_abs_err"])
                                               for r in cases
                                               if "max_abs_err" in r]),
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": b_ms, "bound_by": "operations",
             "library_ms": lib["ms"],
             "by_shape": [{k: r[k] for k in keep if k in r}
                          for rs in rows.values() for r in rs]}
    return entry, counts


def _drop(vcf, keep):
    return dataclasses.replace(vcf, gt=vcf.gt[keep], pos=vcf.pos[keep],
                               chrom=vcf.chrom[keep], ref=vcf.ref[keep],
                               alt=vcf.alt[keep], ids=vcf.ids[keep])


def phase_serving(profile: bool = False) -> dict[str, int]:
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.infer.imputer import Imputer
    from rag_snvbert_tpu_torch.infer.serve import ImputationService
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle

    cfg = PRESETS["tpu_default"]
    t0 = time.perf_counter()
    bundle = make_bundle(n_train_samples=64, n_ref_samples=1004,
                         n_sites=3 * 1020, n_windows=3, seed=17)
    print(f"panel: {bundle.ref.n_samples * 2} reference haplotypes, "
          f"{bundle.ref.n_variants} sites, {bundle.train.n_samples} target "
          f"samples ({time.perf_counter() - t0:.2f} s to generate)")
    model = build_model(cfg, bundle.vocab.size, seed=0)
    m = cfg.model
    print(f"model tpu_default: {m.dims}d/{m.n_layers}L/{m.attn_heads}H, "
          f"seq_len {m.seq_len}, bf16 {m.bf16}, "
          f"{sum(p.numel() for p in model.parameters())} parameters")
    svc = ImputationService.create(model, bundle.ref, bundle.freq,
                                   batch_size=32)
    imp = svc.imputer
    n_win, bs = len(imp.windows), imp.batch_size
    n_samp = bundle.train.n_samples
    batches = n_win * -(-n_samp // bs)
    targets = []
    for seed in (1, 2):
        keep = np.random.default_rng(seed).random(bundle.train.n_variants) \
            >= 0.5
        targets.append((keep, _drop(bundle.train, keep)))

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    results = []
    for i, (keep, target) in enumerate(targets):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = svc.handle_target(target)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        results.append(res)
        n_imp = int(res.imputed_flag.sum()) * n_samp
        print(f"request {i}: {sec:.3f} s, {n_imp} imputed genotypes, "
              f"{n_imp / sec:.0f} imputed genotypes/s")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"attention": m.n_layers * batches * len(targets),
            "attention_bwd": 0, "l2_topk": batches * len(targets),
            "l2_topk_rf": 0, "l2_topk_float": 0}
    print(f"launches {counts} (expected {want}: {n_win} windows x "
          f"{batches // n_win} batches x {len(targets)} requests); peak "
          f"device memory {peak_gb:.2f} GB")
    check(counts == want, "the serving path did not go through every kernel")

    for (keep, target), res in zip(targets, results):
        shape = (bundle.ref.n_variants, n_samp)
        check(res.hap1_prob.shape == shape and res.gt_prob.shape
              == shape + (4,), "result shapes")
        for p in (res.hap1_prob, res.hap2_prob, res.gt_prob):
            check(bool(np.isfinite(p).all() and (p >= 0).all()
                       and (p <= 1).all()), "probabilities outside [0, 1]")
        check(bool(np.abs(res.gt_prob.sum(-1) - 1).max() < 1e-3),
              "gt_prob rows do not sum to 1")
        check((res.imputed_flag == ~keep).all(), "imputed flags")
        check(bool((res.hap1_prob[keep] == bundle.train.gt[keep, :, 0]).all()
                   and (res.hap2_prob[keep]
                        == bundle.train.gt[keep, :, 1]).all()),
              "known sites did not pass through")

    # Window 0 against the plain path on the card: same weights, attention
    # in plain torch math and the plain search (no kernel launches).
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        m, flash_attention=False))
    plain_model = build_model(plain_cfg, bundle.vocab.size, seed=0)
    plain_model.load_state_dict(model.state_dict())
    s, e = imp.windows[0]
    sites = np.zeros(bundle.ref.n_variants, bool)
    sites[s:e] = True
    keep, target = targets[0]
    before = ops.launch_counts()
    plain = Imputer(plain_model, _drop(bundle.ref, sites), bundle.freq,
                    batch_size=32, use_kernel=False).impute(
        _drop(target, sites[keep]))
    check(ops.launch_counts() == before, "the plain path launched a kernel")
    miss = results[0].imputed_flag[s:e]
    diffs = [np.abs(getattr(results[0], f)[s:e][miss]
                    - getattr(plain, f)[miss])
             for f in ("hap1_prob", "hap2_prob", "gt_prob")]
    mean_d = max(float(d.mean()) for d in diffs)
    max_d = max(float(d.max()) for d in diffs)
    print(f"window 0 vs plain path on the card: {int(miss.sum())} imputed "
          f"sites x {n_samp} samples, mean |dp| {mean_d:.3e} (tol "
          f"{PROB_MEAN_TOL}), max |dp| {max_d:.3e} (tol {PROB_MAX_TOL})")
    check(mean_d <= PROB_MEAN_TOL and max_d <= PROB_MAX_TOL,
          "serving output disagrees with the plain path")

    # Persisted window indexes (3.2 GB of float32 a window in the JAX
    # package's npz format, so window 0 alone): written for request 0's
    # missing sites, then the same sites served from them.  The same context
    # bits give request 0's probabilities exactly.
    import tempfile

    ref0, target0 = _drop(bundle.ref, sites), _drop(target, sites[keep])
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        manifest = Imputer(model, ref0, bundle.freq, batch_size=32
                           ).save_window_indexes(tmp, target0)
        save_s = time.perf_counter() - t
        served = Imputer(model, ref0, bundle.freq, batch_size=32,
                         index_dir=tmp)
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = served.impute(target0)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        after = ops.launch_counts()
    same = all(np.array_equal(getattr(res, f), getattr(results[0], f)[s:e])
               for f in ("hap1_prob", "hap2_prob", "gt_prob", "imputed_flag"))
    print(f"index_dir: save_window_indexes {save_s:.2f} s ({manifest}); "
          f"window 0 of request 0 from the file {sec:.3f} s, l2_topk "
          f"launches {after['l2_topk'] - before['l2_topk']}, equal to the "
          f"encoding request {same}")
    check(same and after["l2_topk"] - before["l2_topk"] == batches // n_win,
          "a request served from persisted indexes differs")
    if profile:
        profile_request(svc, targets[1][1])
    return counts

def _write_panel(path: str, panel) -> None:
    with open(path, "w") as f:
        f.write("sample\tpop\n")
        for s, pop in zip(panel.samples, panel.pop_list):
            f.write(f"{s}\t{pop}\n")


def _zlib_header() -> bool:
    """Whether g++ finds zlib.h on its include path."""
    try:
        out = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                             input="#include <zlib.h>\n", capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return out.returncode == 0


def _check_imputed_vcf(path, gt, keep, hap1, hap2) -> None:
    """An imputed VCF read back: GT at the target's known sites from the
    native reader, IMPUTED on exactly the missing sites, HDS against the
    probabilities."""
    from rag_snvbert_tpu_torch.io.vcf import read_vcf

    back = read_vcf(path, use_native=True)
    check(back.gt.shape == (len(keep),) + gt.shape[1:]
          and (back.gt[keep] == gt[keep]).all(),
          f"{path}: GT at the known sites differs from the target")
    info, hds = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            info.append(cols[7] == "IMPUTED")
            hds.append([c.split(":", 2)[1] for c in cols[9:]])
    check(np.array_equal(np.asarray(info), ~keep),
          f"{path}: IMPUTED does not mark exactly the missing sites")
    hds = np.asarray([[v.split(",") for v in row] for row in hds],
                     np.float64)
    err = max(float(np.abs(hds[..., 0] - hap1).max()),
              float(np.abs(hds[..., 1] - hap2).max()))
    check(err <= HDS_TOL, f"{path}: HDS {err:.2e} from the probabilities "
          f"(tol {HDS_TOL})")


def _post(port: int, body: dict) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/impute", body=json.dumps(body))
        r = conn.getresponse()
        resp = json.loads(r.read())
    finally:
        conn.close()
    check(r.status == 200 and resp.get("ok"), f"HTTP /impute: {resp}")
    return resp


def phase_cli(profile: bool = False) -> dict[str, int]:
    """The system's main path through its entry points at tpu_default: VCF
    files in, prepare-data, train, infer, emit-vcf, serve over JSON lines
    (a subprocess) and over HTTP with cross-request batching, imputed VCFs
    out; each verb's kernel launches counted."""
    import threading

    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.cli.main import main as cli
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.infer.httpd import make_server
    from rag_snvbert_tpu_torch.infer.serve import BatchingImputationService
    from rag_snvbert_tpu_torch.io import _native
    from rag_snvbert_tpu_torch.io import vcf as vcf_io
    from rag_snvbert_tpu_torch.io.freq import FreqTable
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle

    cfg = PRESETS["tpu_default"]
    m = cfg.model
    card = card_line()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)

    def at(name: str) -> str:
        return os.path.join(CLI_DIR, name)

    toolchain = shutil.which("g++") is not None and _zlib_header()
    native = _native.get_vcf_reader() is not None
    print(f"VCF reader and writer: {'native' if native else 'Python'} "
          f"({_native.library_path() if native else 'no native library'}; "
          f"g++ and zlib.h {'found' if toolchain else 'not found'})")
    check(native or not toolchain,
          "g++ and zlib.h are here but the native VCF library did not build")

    # 1. the inputs: the serving bundle as VCF files, prepare-data on the
    # reference panel (its frequency table and 1020-site windows)
    bundle = make_bundle(n_train_samples=64, n_ref_samples=1004,
                         n_sites=3 * 1020, n_windows=3, seed=17)
    keep = np.random.default_rng(1).random(bundle.train.n_variants) >= 0.5
    keep2 = np.random.default_rng(2).random(bundle.train.n_variants) >= 0.5
    target, target2 = _drop(bundle.train, keep), _drop(bundle.train, keep2)
    t = time.perf_counter()
    vcf_io.write_simple_vcf(at("ref.vcf"), bundle.ref)
    vcf_io.write_simple_vcf(at("train.vcf"), bundle.train)
    vcf_io.write_simple_vcf(at("target.vcf"), target)
    vcf_io.write_simple_vcf(at("target2.vcf"), target2)
    _write_panel(at("ref.panel"), bundle.ref_panel)
    _write_panel(at("train.panel"), bundle.panel)
    print(f"wrote the VCFs in {time.perf_counter() - t:.2f} s")
    cli(["prepare-data", "--vcf", at("ref.vcf"), "--panel", at("ref.panel"),
         "--out", at("prep"), "--window-len", "1020"])
    model_args = ["--preset", "tpu_default", "--refpanel_path", at("ref.vcf"),
                  "--freq_path", at("prep/freq"), "--panel", at("train.panel"),
                  "--model_path", at("run/ckpt_ep0"), "--batch_size", "32"]
    n_win, n_samp = 3, target.n_samples
    batches = n_win * -(-n_samp // 32)          # one request of 64 targets
    by_verb = {}

    # 2. train: one epoch at the training phase's shape
    ops.reset_launches()
    t = time.perf_counter()
    cli(["train", "--preset", "tpu_default", "--train_dataset",
         at("train.vcf"), "--train_panel", at("train.panel"),
         "--refpanel_path", at("ref.vcf"), "--freq_path", at("prep/freq"),
         "--window_path", at("prep/windows.csv"), "--output_path", at("run"),
         "--epochs", "1", "--train_batch_size", "24",
         "--grad_accum_steps", "2", "--seed", "0"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    by_verb["train"] = ops.launch_counts()
    micro = n_win * -(-bundle.train.n_samples // 24)
    want = {"attention": m.n_layers * micro, "attention_bwd": m.n_layers
            * micro, "l2_topk": micro, "l2_topk_rf": 0, "l2_topk_float": 0}
    print(f"train: {train_s:.2f} s for {micro} micro-steps and a "
          f"checkpoint; launches {by_verb['train']} (expected {want}); "
          f"{card}")
    check(by_verb["train"] == want, "train did not go through every kernel")

    # 3. infer from that checkpoint, then emit-vcf on its .npy files
    ops.reset_launches()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cli(["infer", "--target", at("target.vcf"), "--output_vcf",
         at("infer.vcf"), "--npy_prefix", at("infer"), *model_args])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t
    by_verb["infer"] = ops.launch_counts()
    want = {"attention": m.n_layers * batches, "attention_bwd": 0,
            "l2_topk": batches, "l2_topk_rf": 0, "l2_topk_float": 0}
    print(f"infer: {infer_s:.2f} s (model load, VCF parse, imputation and "
          f"VCF write); launches {by_verb['infer']} (expected {want}); "
          f"{card}")
    check(by_verb["infer"] == want, "infer did not go through every kernel")
    hap1, hap2 = (np.load(at(f"infer.{h}.npy")) for h in ("HAP1", "HAP2"))
    flag = np.load(at("infer.POS_Flag.npy"))
    check(np.array_equal(flag, ~keep), "infer's imputed flags")
    _check_imputed_vcf(at("infer.vcf"), bundle.train.gt, keep, hap1, hap2)
    cli(["emit-vcf", "--npy_prefix", at("infer"), "--refpanel_path",
         at("ref.vcf"), "--output_vcf", at("emit.vcf"), "--samples",
         ",".join(target.samples)])
    with open(at("emit.vcf"), "rb") as a, open(at("infer.vcf"), "rb") as b:
        same = a.read() == b.read()
    print(f"emit-vcf: equal to infer's VCF byte for byte: {same}")
    check(same, "emit-vcf's file differs from infer's")

    # the target VCF parsed and its imputed VCF written by each path
    t = time.perf_counter()
    vcf_io.read_vcf(at("target.vcf"), use_native=True)
    read_nat = time.perf_counter() - t
    t = time.perf_counter()
    vcf_io.read_vcf(at("target.vcf"), use_native=False)
    read_py = time.perf_counter() - t
    args = (bundle.ref.chrom, bundle.ref.pos, bundle.ref.ref, bundle.ref.alt,
            target.samples, hap1, hap2)
    t = time.perf_counter()
    vcf_io.write_imputed_vcf(at("w_native.vcf"), *args, imputed_flag=flag)
    write_nat = time.perf_counter() - t
    real = _native.native_write_vcf_body
    _native.native_write_vcf_body = lambda *a, **k: False
    try:
        t = time.perf_counter()
        vcf_io.write_imputed_vcf(at("w_python.vcf"), *args,
                                 imputed_flag=flag)
        write_py = time.perf_counter() - t
    finally:
        _native.native_write_vcf_body = real
    _check_imputed_vcf(at("w_python.vcf"), bundle.train.gt, keep, hap1, hap2)
    print(f"target VCF ({target.n_variants} sites x {n_samp} samples) parse: "
          f"{'native' if native else 'Python (no native library)'} "
          f"{read_nat:.4f} s, Python {read_py:.4f} s; imputed VCF "
          f"({bundle.ref.n_variants} x {n_samp}) write: "
          f"{'native' if native else 'Python'} {write_nat:.4f} s, Python "
          f"{write_py:.4f} s; {card}")

    # 4. serve over JSON lines in a process of its own (kernels cached in
    # _build/, CUDA initialised there)
    torch.cuda.empty_cache()
    reqs = [{"target": at(f"target{tag}.vcf"), "output_vcf":
             at(f"serve{i}.vcf"), "npy_prefix": at(f"serve{i}")}
            for i, tag in enumerate(("", "2"))]
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rag_snvbert_tpu_torch.cli.main", "serve",
         *model_args], input="".join(json.dumps(r) + "\n" for r in reqs),
        capture_output=True, text=True, timeout=600)
    serve_s = time.perf_counter() - t
    check(proc.returncode == 0, f"serve exited {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    tail = json.loads(proc.stderr.strip().splitlines()[-1])
    by_verb["serve"] = tail["launches"]
    want = {"attention": 2 * m.n_layers * batches, "attention_bwd": 0,
            "l2_topk": 2 * batches, "l2_topk_rf": 0, "l2_topk_float": 0}
    print(f"serve (JSON lines, a subprocess): {serve_s:.2f} s in all; ready "
          f"line {lines[0]}; responses {lines[1:]}; {tail}; request "
          f"seconds {[r.get('seconds') for r in lines[1:]]}; {card}")
    check(lines[0].get("ready") is True and len(lines) == 3
          and all(r.get("ok") for r in lines[1:]) and tail["served"] == 2,
          "serve did not answer both requests")
    check(by_verb["serve"] == want,
          f"serve did not go through every kernel (expected {want})")
    with open(at("serve0.vcf"), "rb") as a, open(at("infer.vcf"), "rb") as b:
        same = a.read() == b.read()
    print(f"serve's first VCF equal to infer's byte for byte: {same}")
    for i, k in enumerate((keep, keep2)):
        _check_imputed_vcf(at(f"serve{i}.vcf"), bundle.train.gt, k,
                           *(np.load(at(f"serve{i}.{h}.npy"))
                             for h in ("HAP1", "HAP2")))

    # 5. HTTP with cross-request batching, in this process: four requests
    # at once (three sample subsets of one missing-site pattern, one of
    # another), then the same four one at a time
    parts = [(0, 24), (24, 48), (48, 64)]
    for i, (a, b) in enumerate(parts):
        vcf_io.write_simple_vcf(at(f"part{i}.vcf"), dataclasses.replace(
            target, gt=target.gt[:, a:b], samples=target.samples[a:b]))
    files = [at(f"part{i}.vcf") for i in range(3)] + [at("target2.vcf")]
    model = build_model(cfg, bundle.vocab.size)
    model.load_state_dict(torch.load(at("run/ckpt_ep0/state.pt"),
                                     map_location="cuda",
                                     weights_only=True)["params"])
    svc = BatchingImputationService.create(
        model, vcf_io.load_vcf_or_hdf5(at("ref.vcf")),
        FreqTable.load(at("prep/freq")), batch_size=32)
    server = make_server(svc)                       # an ephemeral port
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    walls, resps, merges = {}, {}, []
    ops.reset_launches()

    def post(tag: str, i: int) -> None:
        resps[tag, i] = _post(port, {"target": files[i],
                                     "npy_prefix": at(f"{tag}{i}")})

    try:
        # a first request warms the scheduler thread, then two rounds of:
        # the four at once, the four one at a time (the service's own
        # 25 ms linger for merge partners throughout)
        post("warm", 3)
        for r in (0, 1):
            before = dict(svc.stats)
            threads = [threading.Thread(target=post, args=(f"merged{r}_", i))
                       for i in range(4)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            walls["merged", r] = time.perf_counter() - t
            merges.append({k: v - before[k] for k, v in svc.stats.items()})
            t = time.perf_counter()
            for i in range(4):
                post(f"solo{r}_", i)
            walls["solo", r] = time.perf_counter() - t
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    serving.join(timeout=60)
    torch.cuda.synchronize()
    by_verb["http"] = ops.launch_counts()
    check(len(resps) == 17 and not serving.is_alive()
          and not svc._thread.is_alive(), "the HTTP server did not stop")
    print(f"HTTP, BatchingImputationService, after a warm-up request "
          f"({resps['warm', 3]['seconds']} s): ")
    for r in (0, 1):
        print(f"  round {r}: four concurrent requests "
              f"{walls['merged', r]:.3f} s wall (request seconds "
              f"{[resps[f'merged{r}_', i]['seconds'] for i in range(4)]}; "
              f"{merges[r]}), the same four in sequence "
              f"{walls['solo', r]:.3f} s (request seconds "
              f"{[resps[f'solo{r}_', i]['seconds'] for i in range(4)]})")
    print(f"  launches {by_verb['http']}; {card}")
    check(all(d["merged_requests"] >= 2 and d["impute_calls"] < 4
              for d in merges),
          "the concurrent same-pattern requests were not merged")
    worst = 0.0
    for r in (0, 1):
        for i in range(4):
            for h in ("HAP1", "HAP2", "GT"):
                a, b = (np.load(at(f"{tag}{r}_{i}.{h}.npy"))
                        for tag in ("merged", "solo"))
                worst = max(worst, float(np.abs(a - b).max()))
    print(f"merged HTTP results against solo imputation: largest |dp| "
          f"{worst:.3e} (exact expected: the same batch shape)")
    check(worst == 0.0, "merged results differ from solo imputation")
    h = by_verb["http"]
    check(h["l2_topk"] > 0 and h["attention"] == m.n_layers * h["l2_topk"]
          and h["attention_bwd"] == 0, "HTTP serving did not go through "
          "the attention and l2_topk kernels")
    return {k: sum(c.get(k, 0) for c in by_verb.values())
            for k in by_verb["train"]}


# The interop phase: a reference checkpoint at v18_embedding_rag's width
# through convert-ckpt, infer, export-ckpt and train --init-from, under
# INTEROP_DIR (inside the checkout, gitignored).  The convergence phase:
# tools/run_convergence.py on the calibrated panel cut to CONV_WINDOWS
# windows of CONV_SAMPLES samples (the full 1004-sample reference panel),
# under CONV_DIR.
INTEROP_DIR = "runs/chip_smoke_interop"
CONV_DIR = "runs/chip_smoke_convergence"
CONV_WINDOWS, CONV_SAMPLES = 4, 48


def _reference_state_dict(n_layers: int, dims: int, vocab: int,
                          seed: int) -> dict:
    """A reference state_dict of seeded random values by the key/shape
    contract (tests/test_torch_interop.py::fake_state_dict's recipe)."""
    from rag_snvbert_tpu_torch.interop import expected_reference_keys

    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in expected_reference_keys(n_layers, dims, vocab).items():
        if k.endswith("num_batches_tracked"):
            sd[k] = np.asarray(0)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        else:
            sd[k] = rng.normal(0, 0.5, shape).astype(np.float32)
    return sd


def _exact_nearest(q, ctx, ids, plain) -> dict:
    """One top-1 search against the exact nearest rows: distances in
    float64 from the bf16 operands (each product exact), relative to the
    nearest's |q|^2 + |r|^2.  ``kernel_excess``/``plain_excess``: how far
    above the nearest each pick is; ``differ_gap``: the gap from the
    nearest to the second nearest row, largest over the queries whose
    picks differ (a near-tie there explains the difference);
    ``exact_ties``/``near_ties``: queries whose two nearest rows are equal
    / within INTEROP_TIE_REL."""
    n = ctx.ref_emb_search.shape[0]
    qd = q.detach().to(ctx.ref_emb_search.dtype).reshape(q.shape[0], -1)
    qd = qd.double()
    rows = ctx.ref_emb_search.reshape(n, -1)
    q2 = (qd * qd).sum(1)
    d, r2 = [], []
    for i in range(0, n, 256):
        r = rows[i:i + 256].double()
        r2.append((r * r).sum(1))
        d.append(q2[:, None] - 2 * qd @ r.T + r2[-1][None, :])
    d, r2 = torch.cat(d, 1), torch.cat(r2)
    two = d.topk(2, dim=1, largest=False)
    scale = q2 + r2[two.indices[:, 0]]
    gap = (two.values[:, 1] - two.values[:, 0]) / scale

    def excess(pick):
        return ((d.gather(1, pick[:, None])[:, 0] - two.values[:, 0])
                / scale).max().item()

    differ = ids != plain
    return {"queries": len(ids), "rows": n, "differ": int(differ.sum()),
            "kernel_excess": excess(ids), "plain_excess": excess(plain),
            "differ_gap": gap[differ].max().item() if differ.any() else 0.0,
            "exact_ties": int((gap == 0).sum()),
            "near_ties": int((gap <= INTEROP_TIE_REL).sum())}


def phase_interop(profile: bool = False) -> dict[str, int]:
    """A reference checkpoint at v18_embedding_rag's width (384d, 12 layers,
    12 heads, post-LN, float32, frozen BatchNorm statistics) through the
    port's verbs: convert-ckpt, infer on the card over the serving bundle
    (attention dropout 0.1, so the einsum path as in the JAX package, and
    the l2_topk kernel, whose ids are held against the plain search on the
    same inputs), export-ckpt and a reconversion, and two micro-steps of
    train --init-from."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.cli.main import main as cli
    from rag_snvbert_tpu_torch.config import get_preset
    from rag_snvbert_tpu_torch.io import vcf as vcf_io
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.io.windows import Window
    from rag_snvbert_tpu_torch.ops import l2_ref
    from rag_snvbert_tpu_torch.train import retrieval

    m = get_preset("v18_embedding_rag").model
    card = card_line()
    shutil.rmtree(INTEROP_DIR, ignore_errors=True)
    os.makedirs(INTEROP_DIR)

    def at(name: str) -> str:
        return os.path.join(INTEROP_DIR, name)

    bundle = make_bundle(n_train_samples=64, n_ref_samples=1004,
                         n_sites=3 * 1020, n_windows=3, seed=17)
    keep = np.random.default_rng(1).random(bundle.train.n_variants) >= 0.5
    target = _drop(bundle.train, keep)
    vcf_io.write_simple_vcf(at("ref.vcf"), bundle.ref)
    vcf_io.write_simple_vcf(at("train.vcf"), bundle.train)
    vcf_io.write_simple_vcf(at("target.vcf"), target)
    _write_panel(at("ref.panel"), bundle.ref_panel)
    _write_panel(at("train.panel"), bundle.panel)
    cli(["prepare-data", "--vcf", at("ref.vcf"), "--panel", at("ref.panel"),
         "--out", at("prep"), "--window-len", "1020"])
    sd = _reference_state_dict(m.n_layers, m.dims, bundle.vocab.size, 5)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               at("reference.pt"))
    n_win, n_samp = 3, target.n_samples
    batches = n_win * -(-n_samp // 32)
    counts = {}

    # 1. convert-ckpt
    ops.reset_launches()
    t = time.perf_counter()
    cli(["convert-ckpt", "--torch_ckpt", at("reference.pt"), "--out",
         at("conv"), "--attn-heads", str(m.attn_heads)])
    convert_s = time.perf_counter() - t
    with open(at("conv/convert_meta.json")) as f:
        meta = json.load(f)
    print(f"convert-ckpt: {convert_s:.2f} s, {len(sd)} reference tensors "
          f"-> {meta}")
    check((meta["dims"], meta["n_layers"], meta["attn_heads"],
           meta["pos_norm"], meta["pre_ln"]) == (m.dims, m.n_layers,
                                                 m.attn_heads, "frozen_batch",
                                                 False),
          f"convert-ckpt recorded {meta}")

    # 2. infer on the card, every search's ids held against the plain
    # search on the same inputs and against the exact nearest rows
    # (float64; those comparison searches launch nothing)
    real_search, searches = retrieval.search, []

    def held(q, ctx, k, use_kernel=True):
        ids = real_search(q, ctx, k, use_kernel)
        plain = real_search(q, ctx, k, False)
        check(k == 1, f"the converted model searched top-{k}, not top-1")
        searches.append(_exact_nearest(q, ctx, ids[:, 0], plain[:, 0]))
        return ids

    retrieval.search = held
    model_args = ["--refpanel_path", at("ref.vcf"), "--freq_path",
                  at("prep/freq"), "--panel", at("train.panel"),
                  "--model_path", at("conv"), "--batch_size", "32"]
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        cli(["infer", "--target", at("target.vcf"), "--output_vcf",
             at("infer.vcf"), "--npy_prefix", at("infer"), *model_args])
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t
    finally:
        retrieval.search = real_search
    counts["infer"] = ops.launch_counts()
    want = {"attention": 0, "attention_bwd": 0, "l2_topk": batches,
            "l2_topk_rf": 0, "l2_topk_float": 0}
    st = {key: [s[key] for s in searches] for key in searches[0]}
    print(f"infer of the converted model: {infer_s:.2f} s in all (model "
          f"build, checkpoint load, VCF parse, imputation, VCF write); "
          f"launches {counts['infer']} (expected {want}); {len(searches)} "
          f"searches of [{2 * 32}, {searches[0]['rows']}] rows; kernel ids "
          f"differ from the plain search's in {sum(st['differ'])} of "
          f"{sum(st['queries'])} queries; in exact (float64) distances, "
          f"relative to |q|^2+|r|^2: the kernel's pick above the nearest by "
          f"at most {max(st['kernel_excess']):.3e}, the plain pick by "
          f"{max(st['plain_excess']):.3e} (tol {INTEROP_TIE_REL:.0e}); "
          f"nearest-to-second gap where the picks differ at most "
          f"{max(st['differ_gap']):.3e}; queries whose two nearest rows tie "
          f"exactly {sum(st['exact_ties'])}, within the tol "
          f"{sum(st['near_ties'])}; {card}")
    check(counts["infer"] == want, "infer of a converted model did not go "
          "through the l2_topk kernel")
    check(len(searches) == batches
          and max(st["kernel_excess"]) <= INTEROP_TIE_REL
          and max(st["differ_gap"]) <= INTEROP_TIE_REL,
          "the converted model's retrieval differs from the exact nearest "
          "rows, or from the plain search where no near-tie explains it")
    hap1, hap2 = (np.load(at(f"infer.{h}.npy")) for h in ("HAP1", "HAP2"))
    gt = np.load(at("infer.GT.npy"))
    check(bool(np.isfinite(gt).all() and (gt >= 0).all() and (gt <= 1).all()
               and np.abs(gt.sum(-1) - 1).max() < 1e-3),
          "converted-model genotype probabilities")
    _check_imputed_vcf(at("infer.vcf"), bundle.train.gt, keep, hap1, hap2)

    # the converted model behind ImputationService: a cold and a warm
    # request (the same kernels, counted on this path)
    from rag_snvbert_tpu_torch.cli.main import _load_infer_model, \
        build_parser
    from rag_snvbert_tpu_torch.infer.serve import ImputationService
    from rag_snvbert_tpu_torch.io.freq import FreqTable

    args = build_parser().parse_args(["infer", "--target", "x",
                                      "--output_vcf", "x", *model_args])
    model, rag_mode = _load_infer_model(args)
    svc = ImputationService.create(model, bundle.ref,
                                   FreqTable.load(at("prep/freq")),
                                   batch_size=32, rag_mode=rag_mode)
    ops.reset_launches()
    req_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = svc.handle_target(target)
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t)
    counts["requests"] = ops.launch_counts()
    n_imp = int(res.imputed_flag.sum()) * n_samp
    print(f"converted model, ImputationService requests: cold "
          f"{req_s[0]:.3f} s, warm {req_s[1]:.3f} s, {n_imp / req_s[1]:.0f} "
          f"imputed genotypes/s; launches {counts['requests']}; {card}")
    check(counts["requests"]["l2_topk"] == 2 * batches
          and np.array_equal(res.hap1_prob, hap1), "a converted-model "
          "request differs from infer's, or skipped the l2_topk kernel")
    del svc, model
    torch.cuda.empty_cache()

    # 3. export-ckpt, then convert the export again: the same parameters
    # bit for bit
    cli(["export-ckpt", "--ckpt", at("conv"), "--out", at("export.pt")])
    cli(["convert-ckpt", "--torch_ckpt", at("export.pt"), "--out",
         at("conv2"), "--attn-heads", str(m.attn_heads)])
    a, b = (torch.load(at(f"{d}/state.pt"), weights_only=True)["params"]
            for d in ("conv", "conv2"))
    exported = torch.load(at("export.pt"), weights_only=True)
    same_src = all(torch.equal(exported[k], torch.from_numpy(
        np.asarray(v))) for k, v in sd.items()
        if not k.endswith(("num_batches_tracked", "position.pe")))
    round_trip = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                              for k in a)
    print(f"export-ckpt -> convert-ckpt: {len(a)} parameters bit-identical "
          f"{round_trip}; export equal to the source tensors {same_src}")
    check(round_trip and same_src, "export/convert round trip is not exact")

    # 4. train --init-from: 8 samples of the first two windows, batch 8
    # (float32 scores of 12 heads: ~20 GB of activations), one epoch = two
    # micro-steps
    np.save(at("train_samples.npy"), np.arange(8))
    Window(Window.from_file(at("prep/windows.csv")).window_info[:2]
           ).save_csv(at("windows2.csv"))
    ops.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    cli(["train", "--train_dataset", at("train.vcf"), "--train_panel",
         at("train.panel"), "--refpanel_path", at("ref.vcf"), "--freq_path",
         at("prep/freq"), "--window_path", at("windows2.csv"),
         "--output_path", at("finetune"), "--epochs", "1",
         "--train_batch_size", "8", "--grad_accum_steps", "1",
         "--warmup_steps", "5", "--train-samples", at("train_samples.npy"),
         "--init-from", at("conv"), "--seed", "0", "--log_freq", "1"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    counts["train"] = ops.launch_counts()
    want = {"attention": 0, "attention_bwd": 0, "l2_topk": 2,
            "l2_topk_rf": 0, "l2_topk_float": 0}
    state = torch.load(at("finetune/ckpt_ep0/state.pt"), weights_only=True)
    moved = [float((state["params"][k].cpu() - a[k]).abs().max())
             for k in a]
    losses = [json.loads(line)["loss"]
              for line in open(at("finetune/events.jsonl"))
              if '"step"' in line]
    print(f"train --init-from: {train_s:.2f} s for {state['step']} "
          f"micro-steps; losses {losses}; largest parameter move "
          f"{max(moved):.3e}, parameters unmoved {sum(x == 0 for x in moved)}"
          f" of {len(moved)} (FrozenBatchNorm statistics stay); launches "
          f"{counts['train']} (expected {want}); {card}")
    check(counts["train"] == want and state["step"] == 2
          and state["opt_state"]["count"] == 2 and all(np.isfinite(losses)),
          "train --init-from did not take two micro-steps through l2_topk")
    check(0 < max(moved) < 0.05, "the warm start did not start from the "
          "converted weights")
    return {k: sum(c.get(k, 0) for c in counts.values())
            for k in counts["infer"]}


def phase_convergence(profile: bool = False) -> dict[str, int]:
    """tools/run_convergence.py at tpu_default on the calibrated panel cut
    to CONV_WINDOWS windows of CONV_SAMPLES samples (the full 2008-haplotype
    reference): epoch 0 with --profile, then --resume for epoch 1; the
    rare/common F1 columns, the curriculum replayed by the restore, and a
    trace whose summary names the attention and l2_topk kernels."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import PRESETS
    from rag_snvbert_tpu_torch.tools import run_convergence, summarize_trace

    cfg = PRESETS["tpu_default"]
    card = card_line()
    shutil.rmtree(CONV_DIR, ignore_errors=True)
    argv = ["--out", CONV_DIR, "--windows", str(CONV_WINDOWS), "--samples",
            str(CONV_SAMPLES), "--log-freq", "4"]
    ops.reset_launches()
    t = time.perf_counter()
    first = run_convergence.main(argv + ["--epochs", "1", "--profile"])
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    resumed = run_convergence.main(argv + ["--epochs", "2", "--resume"])
    resume_s = time.perf_counter() - t
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    m = cfg.model.n_layers
    micro = CONV_WINDOWS * -(-first["train_samples"] // cfg.batch_size)
    val = CONV_WINDOWS * -(-first["val_samples"] // 48)   # TrainerConfig's
    want = {"attention": 2 * m * (micro + val), "attention_bwd": 2 * m * micro,
            "l2_topk": 2 * (micro + val), "l2_topk_rf": 0, "l2_topk_float": 0}
    with open(os.path.join(CONV_DIR, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    print(f"run_convergence: epoch 0 with --profile {first_s:.1f} s, "
          f"--resume epoch 1 {resume_s:.1f} s ({first['train_samples']} "
          f"train / {first['val_samples']} val samples, {micro} micro-steps "
          f"and {val} validation steps an epoch); launches {counts} "
          f"(expected {want}); {card}")
    for r in rows:
        sps = first["train_samples"] * CONV_WINDOWS / float(
            r["train_epoch_seconds"])
        print("  epoch {epoch} level {level}: train {train_epoch_seconds} s"
              " ({sps:.1f} samples/s), val hap F1 {val_hap_f1}, rare F1 "
              "{val_rare_f1}, common F1 {val_common_f1}".format(sps=sps, **r))
    check(counts == want, "the convergence run did not go through every "
          "kernel")
    check([(r["epoch"], r["level"]) for r in rows] == [("0", "0"), ("1", "1")]
          and resumed["resumed_from"] == 1,
          "the resumed run did not replay the curriculum")
    check(all(0.0 <= float(r[f"{s}_{c}_f1"]) <= 1.0 for r in rows
              for s in ("train", "val") for c in ("rare", "common", "hap")),
          "rare/common F1 columns missing or outside [0, 1]")
    path = summarize_trace.find_trace(os.path.join(CONV_DIR, "profile"))
    text = summarize_trace.summarize(summarize_trace.load_events(path),
                                     top=60, classes=True)
    print("trace of 4 steady micro-steps, device tracks:")
    for line in text.splitlines():
        if line.startswith("== device") or line.startswith(
                ("attention_", "l2_", "void attention", "void l2")):
            print(f"  {line}")
    names = ("attention_fwd_kernel", "attention_bwd_dq_kernel",
             "attention_bwd_dkv_kernel", "l2_partial_dots", "l2_select")
    check("== device" in text and all(n in text for n in names),
          "the trace's summary does not name the attention and l2_topk "
          "kernels")
    return counts


def _int8_layer_check() -> None:
    """One Int8Dense of each shape the encoder has at tpu_default (an
    attention projection 384 -> 384, the FFN's w_1 384 -> 1536 and w_2 1536
    -> 384) on [2 x 32 x 1030] rows of bf16: forward, dx and dw of the
    "fwd_bwd" backward on the card bit-identical to the same call on the
    CPU (the integer products are exact and the float steps are the same
    IEEE operations); the bias gradient, a bf16 sum over the rows in
    another order, to one bf16 rounding."""
    from rag_snvbert_tpu_torch.ops.quant import Int8Dense

    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = 2 * 32 * 1030
    for name, (k, n) in (("attention projection", (384, 384)),
                         ("w_1", (384, 1536)), ("w_2", (1536, 384))):
        layer = Int8Dense(k, n, torch.bfloat16)
        with torch.no_grad():
            layer.weight.copy_(torch.randn(n, k, generator=gen,
                                           device="cuda").cpu() / k ** 0.5)
            layer.bias.copy_(torch.randn(n, generator=gen,
                                         device="cuda").cpu() * 0.1)
        x = torch.randn(rows, k, generator=gen, device="cuda").to(
            torch.bfloat16)
        g = torch.randn(rows, n, generator=gen, device="cuda").to(
            torch.bfloat16)
        got = {}
        for dev in ("cuda", "cpu"):
            lay = copy.deepcopy(layer).to(dev)
            xd = x.to(dev).detach().clone().requires_grad_()
            t = time.perf_counter()
            y = lay(xd)
            y.backward(g.to(dev))
            if dev == "cuda":
                torch.cuda.synchronize()
            got[dev] = ([y.detach(), xd.grad, lay.weight.grad,
                         lay.bias.grad], time.perf_counter() - t)
        (y, dx, dw, db), (y0, dx0, dw0, db0) = got["cuda"][0], got["cpu"][0]
        same = [torch.equal(a.cpu(), b) for a, b in ((y, y0), (dx, dx0),
                                                     (dw, dw0))]
        # the forward's device time beside bf16 F.linear and _int_mm alone
        lay = layer.cuda()
        with torch.no_grad():
            xq = torch.randint(-127, 128, (rows, k), generator=gen,
                               device="cuda", dtype=torch.int8)
            wq = torch.randint(-127, 128, (n, k), generator=gen,
                               device="cuda", dtype=torch.int8)
            t_int8 = time_ms(lambda: lay(x), 20)
            t_bf16 = time_ms(lambda: torch.nn.functional.linear(
                x, lay.weight.to(torch.bfloat16),
                lay.bias.to(torch.bfloat16)), 20)
            t_mm = time_ms(lambda: torch._int_mm(xq, wq.t()), 20)
        db_err = (db.cpu().float() - db0.float()).abs().max().item()
        db_tol = 2 ** -7 * db0.float().abs().max().item()
        print(f"Int8Dense {name} [{rows}, {k}] @ [{k}, {n}] bf16: forward, "
              f"dx, dw on the card equal to the CPU {same}, db max_abs_err "
              f"{db_err:.3e} (tol {db_tol:.3e}); forward {t_int8:.4f} ms "
              f"(bf16 F.linear {t_bf16:.4f}, _int_mm alone {t_mm:.4f})")
        check(all(same) and db_err <= db_tol,
              f"Int8Dense {name}: the card and the CPU differ")


def phase_int8(profile: bool = False) -> dict[str, int]:
    """tpu_default with int8_matmuls=True at full width and depth: two
    requests through ImputationService (the serving phase's bundle), then
    micro-steps on a fixed batch in "fwd_bwd" and one in "fwd", each beside
    the bf16 model with the same weights."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
    from rag_snvbert_tpu_torch.infer.serve import ImputationService
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.ops.quant import Int8Dense
    from rag_snvbert_tpu_torch.train import step
    from rag_snvbert_tpu_torch.train.schedule import make_optimizer
    from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig

    _int8_layer_check()
    base = PRESETS["tpu_default"]
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, int8_matmuls=True))
    m = cfg.model
    per_forward = 6 * m.n_layers      # query, key, value, output, w_1, w_2
    bundle = make_bundle(n_train_samples=64, n_ref_samples=1004,
                         n_sites=3 * 1020, n_windows=3, seed=17)
    models = {"int8": build_model(cfg, bundle.vocab.size, seed=0),
              "bf16": build_model(base, bundle.vocab.size, seed=0)}
    models["bf16"].load_state_dict(models["int8"].state_dict())
    check(sum(isinstance(x, Int8Dense) for x in models["int8"].modules())
          == per_forward and not any(isinstance(x, Int8Dense) for x in
                                     models["bf16"].modules()),
          "the int8 model's projections are not all Int8Dense")
    n_samp = bundle.train.n_samples
    keep = np.random.default_rng(1).random(bundle.train.n_variants) >= 0.5
    target = _drop(bundle.train, keep)
    counts = {k: 0 for k in ops.launch_counts()}
    results, rate = {}, {}
    for kind in ("int8", "bf16"):
        svc = ImputationService.create(models[kind], bundle.ref, bundle.freq,
                                       batch_size=32)
        imp = svc.imputer
        batches = len(imp.windows) * -(-n_samp // imp.batch_size)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        Int8Dense.calls = 0
        secs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = svc.handle_target(target)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        results[kind] = res
        n_imp = int(res.imputed_flag.sum()) * n_samp
        rate[kind] = n_imp / secs[1]
        print(f"{kind} serving: requests {[round(x, 3) for x in secs]} s, "
              f"{n_imp} imputed genotypes, warm {rate[kind]:.0f} imputed "
              f"genotypes/s; Int8Dense calls {Int8Dense.calls}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if kind == "int8":
            counts = ops.launch_counts()
            want = {**{k: 0 for k in counts},
                    "attention": m.n_layers * 2 * batches,
                    "l2_topk": 2 * batches}
            check(counts == want and Int8Dense.calls
                  == per_forward * 2 * batches,
                  f"int8 serving launches {counts} (expected {want}), "
                  f"Int8Dense calls {Int8Dense.calls} (expected "
                  f"{per_forward * 2 * batches})")
            for p in (res.hap1_prob, res.hap2_prob, res.gt_prob):
                check(bool(np.isfinite(p).all() and (p >= 0).all()
                           and (p <= 1).all()),
                      "int8 probabilities outside [0, 1]")
            check((res.hap1_prob[keep] == bundle.train.gt[keep, :, 0]).all()
                  and (res.imputed_flag == ~keep).all(),
                  "int8 serving: known sites or flags")
    miss = results["int8"].imputed_flag
    diffs = [np.abs(getattr(results["int8"], f)[miss]
                    - getattr(results["bf16"], f)[miss])
             for f in ("hap1_prob", "hap2_prob", "gt_prob")]
    mean_d = max(float(d.mean()) for d in diffs)
    max_d = max(float(d.max()) for d in diffs)
    print(f"int8 against bf16 serving, same weights: {int(miss.sum())} "
          f"imputed sites x {n_samp} samples, mean |dp| {mean_d:.3e} (tol "
          f"{INT8_PROB_MEAN_TOL}), max |dp| {max_d:.3e} (tol "
          f"{INT8_PROB_MAX_TOL}); genotypes/s int8 {rate['int8']:.0f}, bf16 "
          f"{rate['bf16']:.0f}")
    check(mean_d <= INT8_PROB_MEAN_TOL and max_d <= INT8_PROB_MAX_TOL,
          "int8 serving strays from the bf16 model")

    # Micro-steps on one fixed batch at the preset's peak lr, no warmup:
    # "fwd_bwd" (int8 forward and gradient products), then one "fwd" step;
    # the bf16 model from the same weights takes the same steps.
    ds = WindowDataset(bundle.train, bundle.panel, bundle.freq,
                       bundle.window.window_info, bundle.vocab,
                       ref_vcf=bundle.ref, seq_len=m.seq_len)
    tcfg = TrainerConfig(epochs=1, batch_size=cfg.batch_size,
                         ref_pad_haps=2048, output_dir=INT8_TRAIN_DIR,
                         rag_k=cfg.rag_k, seed=0)
    shutil.rmtree(INT8_TRAIN_DIR, ignore_errors=True)
    meta = ds.windows[0]
    for kind in ("int8", "bf16"):
        trainer = Trainer(models[kind], ds, tcfg)
        batch = trainer._put_batch(ds.make_batch(
            meta, np.arange(tcfg.batch_size), 0, 0, packed=True))
        ctx = trainer._window_ctx(ds, meta, 0, 0)
        model = trainer.model
        opt = make_optimizer(model, cfg.max_lr, cfg.max_lr, 1)
        torch.cuda.reset_peak_memory_stats()
        if kind == "int8":
            ops.reset_launches()
            Int8Dense.calls = 0
        before = step.eval_step(model, batch, ctx, trainer.step_cfg)["loss"]
        times, losses = [], []
        for i in range(6):
            if kind == "int8" and i == 5:
                for mod in model.modules():
                    if isinstance(mod, Int8Dense):
                        mod.mode = "fwd"
            gen = step.step_generator(0, 2000 + i, trainer.device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            stats = step.train_step(model, opt, batch, ctx, trainer.step_cfg,
                                    gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(stats["loss"].item())
        after = step.eval_step(model, batch, ctx, trainer.step_cfg)["loss"]
        warm = statistics.median(times[1:5])
        print(f"{kind} micro-steps (batch {tcfg.batch_size}, L "
              f"{m.seq_len}, a 2048-row context): "
              f"{[round(x * 1e3, 1) for x in times]} ms, warm median "
              f"{warm * 1e3:.1f} ms, {tcfg.batch_size / warm:.1f} training "
              f"samples/s; train losses {[round(x, 4) for x in losses]}; "
              f"eval loss of the batch {before.item():.4f} -> "
              f"{after.item():.4f}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if kind == "int8":
            steps = len(times)
            train = ops.launch_counts()
            want = {**{k: 0 for k in train},
                    "attention": m.n_layers * (steps + 2),
                    "attention_bwd": m.n_layers * steps,
                    "l2_topk": steps + 2}
            check(train == want and Int8Dense.calls
                  == per_forward * (steps + 2),
                  f"int8 training launches {train} (expected {want}), "
                  f"Int8Dense calls {Int8Dense.calls} (expected "
                  f"{per_forward * (steps + 2)})")
            check(all(np.isfinite(losses)) and bool(torch.isfinite(after))
                  and after.item() < before.item(),
                  "the int8 model's loss did not fall on a fixed batch")
            counts = {k: counts[k] + train[k] for k in counts}
        del trainer, opt, model
        torch.cuda.empty_cache()
    return counts


def _set_dropout(model, rate: float) -> None:
    from rag_snvbert_tpu_torch.models.layers import Dropout

    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = rate


def _grads_of_one_batch(model, batch, ctx_of, use_kernel: bool):
    """Loss and every parameter's gradient of one batch in train mode with
    dropout off."""
    from rag_snvbert_tpu_torch.train import step

    _set_dropout(model, 0.0)
    model.train()
    ctx = ctx_of(model)
    loss, _, _ = step._forward(model, batch, ctx,
                               step.StepConfig(use_kernel=use_kernel))
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    model.zero_grad()
    return loss.item(), grads


def _per_tensor_step(opt, grads) -> None:
    """``Optimizer.step`` as a loop over the tensors, one formula each (the
    optimizer before its multi-tensor form, but for the accumulation's
    divisor, a device tensor as in the optimizer: the formulas
    test_optimizer_matches_optax pins on the CPU)."""
    if opt.acc is not None:
        n = opt.mini_step
        n1 = torch.tensor(n + 1, dtype=torch.float32, device="cuda")
        for a, g in zip(opt.acc, grads):
            a.copy_(a + (g - a) / n1)
        if n < opt.accum_steps - 1:
            opt.mini_step = n + 1
            return
        grads = opt.acc
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    below = norm < opt.clip_norm
    lr = opt.schedule(opt.count)
    opt.count += 1
    bc1 = (1 - torch.tensor(opt.b1) ** opt.count).to(norm.device)
    bc2 = (1 - torch.tensor(opt.b2) ** opt.count).to(norm.device)
    for p, g, mu, nu in zip(opt.params, grads, opt.mu, opt.nu):
        g = torch.where(below, g, g / norm * opt.clip_norm)
        mu.copy_((1 - opt.b1) * g + opt.b1 * mu)
        nu.copy_((1 - opt.b2) * torch.square(g) + opt.b2 * nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps)
        p.copy_(p + -lr * u)
    if opt.acc is not None:
        for a in opt.acc:
            a.zero_()
        opt.mini_step = 0


def _optimizer_check(opt, grad_scale: float, clipped: bool) -> None:
    """The optimizer's multi-tensor update on the card against the same
    step as a loop over the tensors (``_per_tensor_step``), from ``opt``'s
    state with the same gradients: accum_steps micro-steps, one of them an
    update, bit for bit.  (Not against the CPU: CUDA's float32 sqrt rounds
    unlike the CPU's.)  ``clipped``: the mean gradient's global norm is
    above the clip, else below."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    grads = [[torch.randn(p.shape, generator=gen, device="cuda") * grad_scale
              for p in opt.params] for _ in range(opt.accum_steps)]
    norm = math.sqrt(sum(float(torch.sum(torch.square(
        sum(g[i] for g in grads) / len(grads))))
        for i in range(len(opt.params))))
    check((norm > opt.clip_norm) == clipped, f"optimizer check: mean "
          f"gradient norm {norm:.3g} against the clip {opt.clip_norm}")
    ref = copy.deepcopy(opt)
    ref.params = [p.detach().clone() for p in opt.params]
    for step_grads in grads:            # accum_steps calls: one updates
        for p, g in zip(opt.params, step_grads):
            p.grad = g
        opt.step()
        opt.zero_grad()
        _per_tensor_step(ref, step_grads)
    torch.cuda.synchronize()
    same = {key: all(torch.equal(a, b) for a, b in
                     zip(getattr(opt, key) or [], getattr(ref, key) or []))
            for key in ("params", "mu", "nu", "acc")}
    print(f"optimizer: {opt.accum_steps} micro-steps with an update over "
          f"{len(opt.params)} tensors (mean gradient norm {norm:.3g}, clip "
          f"{opt.clip_norm}), multi-tensor against per-tensor on the card, "
          f"bit for bit: {same}")
    check(opt.count == ref.count and all(same.values()), "the optimizer's "
          "multi-tensor update differs from the per-tensor one")


def phase_training(profile: bool = False) -> dict[str, int]:
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.train import step
    from rag_snvbert_tpu_torch.train.retrieval import encode_window_refs
    from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = PRESETS["tpu_default"]
    m = cfg.model
    t0 = time.perf_counter()
    bundle = make_bundle(n_train_samples=48, n_ref_samples=1004,
                         n_sites=2 * 1020, n_windows=2, seed=23)
    ds = WindowDataset(bundle.train, bundle.panel, bundle.freq,
                       bundle.window.window_info, bundle.vocab,
                       ref_vcf=bundle.ref, seq_len=m.seq_len)
    print(f"training panel: {bundle.ref.n_samples * 2} reference haplotypes "
          f"(context padded to 2048), {ds.n_windows} windows of "
          f"{[w.n_sites for w in ds.windows]} sites, "
          f"{bundle.train.n_samples} training samples "
          f"({time.perf_counter() - t0:.2f} s to generate)")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    tcfg = TrainerConfig(
        epochs=1, batch_size=cfg.batch_size, val_batch_size=cfg.val_batch_size,
        init_lr=cfg.init_lr, max_lr=cfg.max_lr, warmup_steps=cfg.warmup_steps,
        grad_accum_steps=cfg.grad_accum_steps, focal_gamma=cfg.focal_gamma,
        rag_k=cfg.rag_k, ref_pad_haps=2048, output_dir=TRAIN_DIR,
        log_freq=1, seed=0)
    trainer = Trainer(build_model(cfg, bundle.vocab.size, seed=0), ds, tcfg,
                      val_ds=ds)
    micro = ds.n_windows * -(-ds.n_samples // tcfg.batch_size)
    val_steps = ds.n_windows * -(-ds.n_samples // tcfg.val_batch_size)

    # (ii) parameters change at every update and at no other micro-step
    opt = trainer.optimizer
    plain_step, changed = opt.step, []

    def checked_step():
        before = [p.detach().clone() for p in opt.params]
        applied = plain_step()
        moved = sum(not torch.equal(b, p) for b, p in zip(before, opt.params))
        changed.append((applied, moved))
        return applied

    opt.step = checked_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    result = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts = ops.launch_counts()
    opt.step = plain_step
    peak_fit = torch.cuda.max_memory_allocated() / 1e9
    want = {"attention": m.n_layers * (micro + val_steps),
            "attention_bwd": m.n_layers * micro,
            "l2_topk": micro + val_steps, "l2_topk_rf": 0,
            "l2_topk_float": 0}
    print(f"fit: {fit_s:.2f} s for {micro} micro-steps ({opt.count} updates) "
          f"+ {val_steps} validation steps + a checkpoint; launches {counts} "
          f"(expected {want}); peak device memory {peak_fit:.2f} GB")
    check(counts == want, "training did not go through every kernel")
    row = result["history"][0]
    print("epoch 0: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()
                                  if isinstance(v, float)))
    check(all(np.isfinite(row[k]) for k in ("train_loss", "train_hap_loss",
                                            "train_gt_loss", "val_loss")),
          "training loss is not finite")
    check(0.0 <= row["val_hap_f1"] <= 1.0, "val_hap_f1 outside [0, 1]")
    n_params = len(opt.params)
    print(f"parameter tensors moved per micro-step (of {n_params}): "
          f"{[(a, n) for a, n in changed]}")
    check(opt.count == micro // tcfg.grad_accum_steps
          and [a for a, _ in changed] == [False, True] * (micro // 2),
          "updates were not applied every second micro-step")
    check(all((n >= 0.95 * n_params) if a else n == 0 for a, n in changed),
          "parameters did not move at an update, or moved between updates")

    # (iv) the checkpoint restores exactly into a fresh trainer
    fresh = Trainer(build_model(cfg, bundle.vocab.size, seed=1), ds, tcfg)
    fresh.restore_checkpoint(os.path.join(TRAIN_DIR, "ckpt_ep0"))
    same = all(torch.equal(fresh.model.state_dict()[k], v)
               for k, v in trainer.model.state_dict().items())
    a, b = opt.state_dict(), fresh.optimizer.state_dict()
    same_opt = (a["count"], a["mini_step"]) == (b["count"], b["mini_step"]) \
        and all(torch.equal(a[key][n], b[key][n])
                for key in ("mu", "nu", "acc") for n in a[key])
    print(f"restore: params equal {same}, optimizer state equal {same_opt}, "
          f"step {fresh.step} epoch {fresh.start_epoch} level {fresh.level}")
    check(same and same_opt and fresh.step == trainer.step
          and (fresh.start_epoch, fresh.level) == (1, 0)
          and dataclasses.asdict(fresh.stopper)
          == dataclasses.asdict(trainer.stopper),
          "checkpoint round trip is not exact")
    del fresh

    # Warm micro-steps on one batch, each timed to a synchronize; with
    # accumulation 2 they alternate between accumulate-only and update.
    meta = ds.windows[0]
    batch = trainer._put_batch(ds.make_batch(
        meta, np.arange(tcfg.batch_size), 0, 0, packed=True))
    ctx = trainer._window_ctx(ds, meta, 0, 0)
    times = {False: [], True: []}
    for i in range(9):
        gen = step.step_generator(0, 1000 + i, trainer.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step.train_step(trainer.model, opt, batch, ctx, trainer.step_cfg, gen)
        torch.cuda.synchronize()
        if i:                                # the first one warms up
            times[opt.mini_step == 0].append(time.perf_counter() - t)
    acc_ms, upd_ms = (statistics.median(times[k]) * 1e3 for k in (False,
                                                                    True))
    mean_s = statistics.mean(times[False] + times[True])
    print(f"warm micro-step (batch {tcfg.batch_size}, L {m.seq_len}, one "
          f"window of a 2048-row context): accumulate-only median "
          f"{acc_ms:.1f} ms {[round(x * 1e3, 1) for x in times[False]]}, "
          f"with the update median {upd_ms:.1f} ms "
          f"{[round(x * 1e3, 1) for x in times[True]]}; mean "
          f"{mean_s * 1e3:.1f} ms, {tcfg.batch_size / mean_s:.1f} training "
          f"samples/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if profile:
        profile_train_steps(trainer, opt, batch, ctx)
    _optimizer_check(opt, grad_scale=1e-2, clipped=True)
    # below the clip, and an average over three micro-steps (a division
    # by 3), from a copy of the trained state
    from rag_snvbert_tpu_torch.train.schedule import Optimizer
    three = Optimizer([(n, p.detach().clone()) for n, p in
                       zip(opt.names, opt.params)], accum_steps=3)
    for key in ("mu", "nu"):
        for dst, src in zip(getattr(three, key), getattr(opt, key)):
            dst.copy_(src)
    three.count = opt.count
    _optimizer_check(three, grad_scale=1e-6, clipped=False)
    del three

    # (iii) one batch, dropout off: the kernel path against the plain path
    # on the card (same weights: attention in plain torch math with float32
    # scores, the plain search; no kernel launches).
    state = trainer.model.state_dict()
    del trainer, opt
    torch.cuda.empty_cache()
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        m, flash_attention=False, score_bf16=False))

    def ctx_of(model):
        model.eval()
        toks, af, valid = (torch.from_numpy(x).cuda() for x in
                           ds.window_ref_tokens(meta, pad_haps_to=2048))
        wmask = torch.from_numpy(ds.window_mask(meta, 0, 0)).cuda()
        return encode_window_refs(model.embed, toks.long(), af, wmask,
                                  valid=valid)

    model = build_model(cfg, bundle.vocab.size, seed=0)
    model.load_state_dict(state)
    ops.reset_launches()
    k_loss, k_grads = _grads_of_one_batch(model, batch, ctx_of, True)
    one = ops.launch_counts()
    check(one == {"attention": m.n_layers, "attention_bwd": m.n_layers,
                  "l2_topk": 1, "l2_topk_rf": 0, "l2_topk_float": 0},
          f"kernel path launches {one}")
    del model
    model = build_model(plain_cfg, bundle.vocab.size, seed=0)
    model.load_state_dict(state)
    ops.reset_launches()
    p_loss, p_grads = _grads_of_one_batch(model, batch, ctx_of, False)
    check(not any(ops.launch_counts().values()),
          "the plain path launched a kernel")
    total = torch.sqrt(sum((g.double() ** 2).sum()
                           for g in p_grads.values())).item()
    rels = {}
    for name, g in p_grads.items():
        denom = max(g.norm().item(), 1e-3 * total)
        rels[name] = (k_grads[name] - g).norm().item() / denom
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:5]
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    print(f"one batch, dropout off, kernel vs plain path on the card: loss "
          f"{k_loss:.4f} vs {p_loss:.4f} (rel {loss_rel:.2e}, tol "
          f"{TRAIN_LOSS_TOL}); gradient rel L2 median "
          f"{statistics.median(rels.values()):.2e}, worst "
          + ", ".join(f"{n} {r:.2e}" for n, r in worst)
          + f" (tol {TRAIN_GRAD_TOL})")
    check(loss_rel <= TRAIN_LOSS_TOL and max(rels.values()) <= TRAIN_GRAD_TOL
          and all(bool(torch.isfinite(g).all()) for g in k_grads.values()),
          "training gradients disagree with the plain path")
    return counts


def _recording(module, store: list):
    """Wrap ``module.retrieve_tokens`` so each call's retrieved segments
    are kept; returns the original to put back."""
    real = module.retrieve_tokens

    def rec(*a, **kw):
        out = real(*a, **kw)
        store.append((out["rag_seg_h1"].cpu(), out["rag_seg_h2"].cpu()))
        return out

    module.retrieve_tokens = rec
    return real


def phase_token_serving(profile: bool = False) -> dict[str, int]:
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.infer import imputer as imputer_mod
    from rag_snvbert_tpu_torch.infer.imputer import Imputer
    from rag_snvbert_tpu_torch.infer.serve import ImputationService
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle

    cfg = PRESETS["v17_token_rag"]
    m = cfg.model
    bundle = make_bundle(n_train_samples=64, n_ref_samples=1004,
                         n_sites=3 * 1020, n_windows=3, seed=17)
    model = build_model(cfg, bundle.vocab.size, seed=0)
    print(f"model v17_token_rag: {m.dims}d/{m.n_layers}L/{m.attn_heads}H, "
          f"seq_len {m.seq_len}, bf16 {m.bf16}, attention dropout "
          f"{m.dropout if m.attn_dropout is None else m.attn_dropout}, "
          f"{sum(p.numel() for p in model.parameters())} parameters")
    svc = ImputationService.create(model, bundle.ref, bundle.freq,
                                   batch_size=32, rag_mode="token")
    imp = svc.imputer
    n_win, n_samp = len(imp.windows), bundle.train.n_samples
    batches = n_win * -(-n_samp // imp.batch_size)
    targets = []
    for seed in (1, 2):
        keep = np.random.default_rng(seed).random(bundle.train.n_variants) \
            >= 0.5
        targets.append((keep, _drop(bundle.train, keep)))

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    results = []
    for i, (keep, target) in enumerate(targets):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = svc.handle_target(target)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        results.append(res)
        n_imp = int(res.imputed_flag.sum()) * n_samp
        print(f"token request {i}: {sec:.3f} s, {n_imp} imputed genotypes, "
              f"{n_imp / sec:.0f} imputed genotypes/s")
    counts = ops.launch_counts()
    want = {"attention": 0, "attention_bwd": 0, "l2_topk": 0,
            "l2_topk_rf": batches * len(targets), "l2_topk_float": 0}
    print(f"token launches {counts} (expected {want}: {n_win} windows x "
          f"{batches // n_win} batches x {len(targets)} requests); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(counts == want, "token serving did not go through l2_topk_rf")
    for (keep, target), res in zip(targets, results):
        shape = (bundle.ref.n_variants, n_samp)
        check(res.hap1_prob.shape == shape and res.gt_prob.shape
              == shape + (4,), "token result shapes")
        for p in (res.hap1_prob, res.hap2_prob, res.gt_prob):
            check(bool(np.isfinite(p).all() and (p >= 0).all()
                       and (p <= 1).all()), "probabilities outside [0, 1]")
        check(bool(np.abs(res.gt_prob.sum(-1) - 1).max() < 1e-3),
              "gt_prob rows do not sum to 1")
        check((res.imputed_flag == ~keep).all(), "imputed flags")
        check(bool((res.hap1_prob[keep] == bundle.train.gt[keep, :, 0]).all()
                   and (res.hap2_prob[keep]
                        == bundle.train.gt[keep, :, 1]).all()),
              "known sites did not pass through")

    # Window 0, kernel search vs plain search on the card (same model):
    # the same segments come back, so the same probabilities.
    s, e = imp.windows[0]
    sites = np.zeros(bundle.ref.n_variants, bool)
    sites[s:e] = True
    keep, target = targets[0]
    window = {}
    for use_kernel in (True, False):
        segs: list = []
        real = _recording(imputer_mod, segs)
        try:
            before = ops.launch_counts()["l2_topk_rf"]
            res = Imputer(model, _drop(bundle.ref, sites), bundle.freq,
                          batch_size=32, rag_mode="token",
                          use_kernel=use_kernel).impute(
                _drop(target, sites[keep]))
            launched = ops.launch_counts()["l2_topk_rf"] - before
        finally:
            imputer_mod.retrieve_tokens = real
        check(launched == (len(segs) if use_kernel else 0),
              f"window 0 launches {launched} with use_kernel={use_kernel}")
        window[use_kernel] = (res, segs)
    (kres, ksegs), (pres, psegs) = window[True], window[False]
    same_segs = len(ksegs) == len(psegs) and all(
        torch.equal(a, c) and torch.equal(b, d)
        for (a, b), (c, d) in zip(ksegs, psegs))
    miss = results[0].imputed_flag[s:e]
    d_plain = max(float(np.abs(getattr(kres, f)[miss]
                               - getattr(pres, f)[miss]).max())
                  for f in ("hap1_prob", "hap2_prob", "gt_prob"))
    d_req = max(float(np.abs(getattr(results[0], f)[s:e][miss]
                             - getattr(kres, f)[miss]).max())
                for f in ("hap1_prob", "hap2_prob", "gt_prob"))
    print(f"token window 0, kernel vs plain search on the card: "
          f"{len(ksegs)} batches, retrieved segments equal {same_segs}; "
          f"max |dp| vs plain {d_plain:.3e}, vs the request {d_req:.3e} "
          f"(tol {TOKEN_PROB_TOL})")
    check(same_segs and d_plain <= TOKEN_PROB_TOL
          and d_req <= TOKEN_PROB_TOL,
          "token serving disagrees with the plain search path")
    if profile:
        profile_request(svc, targets[1][1])
    return counts


def phase_token_training(profile: bool = False) -> dict[str, int]:
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.train import step
    from rag_snvbert_tpu_torch.train.retrieval import build_token_window_ctx
    from rag_snvbert_tpu_torch.train.schedule import make_optimizer
    from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = PRESETS["v17_token_rag"]
    m = cfg.model
    bundle = make_bundle(n_train_samples=32, n_ref_samples=1004,
                         n_sites=2 * 1020, n_windows=2, seed=23)
    ds = WindowDataset(bundle.train, bundle.panel, bundle.freq,
                       bundle.window.window_info, bundle.vocab,
                       ref_vcf=bundle.ref, seq_len=m.seq_len)
    shutil.rmtree(TOKEN_TRAIN_DIR, ignore_errors=True)
    tcfg = TrainerConfig(
        epochs=1, batch_size=cfg.batch_size, val_batch_size=cfg.val_batch_size,
        init_lr=cfg.init_lr, max_lr=cfg.max_lr, warmup_steps=cfg.warmup_steps,
        grad_accum_steps=cfg.grad_accum_steps, focal_gamma=cfg.focal_gamma,
        rag_k=cfg.rag_k, ref_pad_haps=2048, output_dir=TOKEN_TRAIN_DIR,
        log_freq=1, seed=0, rag_mode="token")
    trainer = Trainer(build_model(cfg, bundle.vocab.size, seed=0), ds, tcfg,
                      val_ds=ds)
    micro = ds.n_windows * -(-ds.n_samples // tcfg.batch_size)
    val_steps = ds.n_windows * -(-ds.n_samples // tcfg.val_batch_size)
    opt = trainer.optimizer
    plain_step, changed = opt.step, []

    def checked_step():
        before = [p.detach().clone() for p in opt.params]
        applied = plain_step()
        changed.append((applied, sum(not torch.equal(b, p) for b, p in
                                     zip(before, opt.params))))
        return applied

    opt.step = checked_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    result = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts = ops.launch_counts()
    opt.step = plain_step
    want = {"attention": 0, "attention_bwd": 0, "l2_topk": 0,
            "l2_topk_rf": micro + val_steps, "l2_topk_float": 0}
    print(f"token fit (v17_token_rag, batch {tcfg.batch_size}, accumulation "
          f"{tcfg.grad_accum_steps}): {fit_s:.2f} s for {micro} micro-steps "
          f"+ {val_steps} validation steps + a checkpoint; launches {counts} "
          f"(expected {want}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(counts == want, "token training did not go through l2_topk_rf")
    row = result["history"][0]
    check(all(np.isfinite(row[k]) for k in ("train_loss", "val_loss")),
          "token training loss is not finite")
    n_params = len(opt.params)
    print(f"parameter tensors moved per micro-step (of {n_params}): "
          f"{changed}")
    check(len(changed) == micro and all(a and n >= 0.95 * n_params
                                        for a, n in changed),
          "token training updates did not land at every micro-step")

    # Warm steps on one batch with a fresh optimizer at the preset's peak
    # lr (5e-5, no warmup): each timed to a synchronize; the deterministic
    # (eval) loss of the batch falls.  (At 5e-4 the post-LN model, without
    # warmup, rose instead on an H100.)
    meta = ds.windows[0]
    batch = trainer._put_batch(ds.make_batch(
        meta, np.arange(tcfg.batch_size), 0, 0, packed=True))
    ctx = trainer._window_ctx(ds, meta, 0, 0)
    model = trainer.model
    before = step.eval_step(model, batch, ctx, trainer.step_cfg)["loss"]
    fast = make_optimizer(model, cfg.max_lr, cfg.max_lr, 1)
    times = []
    for i in range(7):
        gen = step.step_generator(0, 1000 + i, trainer.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step.train_step(model, fast, batch, ctx, trainer.step_cfg, gen)
        torch.cuda.synchronize()
        if i:                                # the first one warms up
            times.append(time.perf_counter() - t)
    after = step.eval_step(model, batch, ctx, trainer.step_cfg)["loss"]
    mean_s = statistics.mean(times)
    print(f"token warm micro-step (batch {tcfg.batch_size}, L {m.seq_len}, "
          f"a 2048-row context): median "
          f"{statistics.median(times) * 1e3:.1f} ms "
          f"{[round(x * 1e3, 1) for x in times]}, mean {mean_s * 1e3:.1f} "
          f"ms, {tcfg.batch_size / mean_s:.1f} training samples/s; eval loss "
          f"of the batch {before.item():.4f} -> {after.item():.4f}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(bool(torch.isfinite(after)) and after.item() < before.item(),
          "the token model's loss did not fall on a fixed batch")
    if profile:
        profile_train_steps(trainer, fast, batch, ctx)

    # One batch, dropout off: kernel search vs plain search on the card.
    state = model.state_dict()
    del trainer, opt, fast, model
    torch.cuda.empty_cache()

    def ctx_of(_model):
        toks, _, valid = (torch.from_numpy(x).cuda() for x in
                          ds.window_ref_tokens(meta, pad_haps_to=2048))
        wmask = torch.from_numpy(ds.window_mask(meta, 0, 0)).cuda()
        return build_token_window_ctx(toks.long(), wmask, valid=valid)

    grads = {}
    for use_kernel in (True, False):
        model = build_model(cfg, bundle.vocab.size, seed=0)
        model.load_state_dict(state)
        ops.reset_launches()
        grads[use_kernel] = _grads_of_one_batch(model, batch, ctx_of,
                                                use_kernel)
        check(ops.launch_counts()["l2_topk_rf"] == int(use_kernel),
              f"one batch, use_kernel={use_kernel}: launches "
              f"{ops.launch_counts()}")
        del model
    (k_loss, k_grads), (p_loss, p_grads) = grads[True], grads[False]
    total = torch.sqrt(sum((g.double() ** 2).sum()
                           for g in p_grads.values())).item()
    rels = {n: (k_grads[n] - g).norm().item()
            / max(g.norm().item(), 1e-3 * total) for n, g in p_grads.items()}
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    print(f"token one batch, dropout off, kernel vs plain search on the card: "
          f"loss {k_loss:.6f} vs {p_loss:.6f} (rel {loss_rel:.2e}, tol "
          f"{TOKEN_LOSS_TOL}); worst gradient rel L2 "
          f"{max(rels.values()):.2e} (tol {TOKEN_GRAD_TOL})")
    check(loss_rel <= TOKEN_LOSS_TOL and max(rels.values()) <= TOKEN_GRAD_TOL
          and all(bool(torch.isfinite(g).all()) for g in k_grads.values()),
          "token training gradients disagree with the plain search path")
    return counts


def profile_train_steps(trainer, opt, batch, ctx) -> None:
    """Two more micro-steps under torch.profiler, one accumulate-only and
    one with the optimizer update: device time by kernel and the device's
    busy share of their wall time."""
    from torch.profiler import ProfilerActivity, profile

    from rag_snvbert_tpu_torch.train import step

    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(2):
            gen = step.step_generator(0, 2000 + i, trainer.device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            step.train_step(trainer.model, opt, batch, ctx, trainer.step_cfg,
                            gen)
            torch.cuda.synchronize()
            walls.append(((time.perf_counter() - t) * 1e3,
                          "update" if opt.mini_step == 0 else "accumulate"))
    print("profiled micro-steps: "
          + ", ".join(f"{ms:.1f} ms ({kind})" for ms, kind in walls))
    _print_profile("two training micro-steps", prof,
                   sum(ms for ms, _ in walls))


def profile_request(svc, target) -> None:
    """One more request under torch.profiler: device time by kernel and the
    device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        svc.handle_target(target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    _print_profile("request", prof, wall_ms)


def _print_profile(what: str, prof, wall_ms: float) -> None:
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile: {what} wall {wall_ms:.1f} ms, device kernels "
          f"{busy_ms:.1f} ms, device idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
              f"{e.key[:100]}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs the port on the card")
    from rag_snvbert_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    t = time.perf_counter()
    report = _build.build()
    print(f"kernel build: {time.perf_counter() - t:.2f} s wall for "
          f"{sorted(report) or 'nothing (already built)'}")
    for name in _build.KERNELS:
        took = f"{report[name]:.2f} s" if name in report else "built before"
        print(f"  {name}: {took}; ptxas per kernel (registers, spill "
              f"stores/loads bytes): "
              + "; ".join(f"{k} {r}, {st}/{ld}" for k, r, st, ld
                          in _build.ptxas_entries(name)))
        notes = [line.strip() for line in _build.ptxas_log(name).splitlines()
                 if "Performance Loss" in line]
        for line in notes:
            print(f"    {line}")
        # a spill, or ptxas serializing a kernel's wgmma pipeline (an info
        # note, 25-30% slower), is a fault of the build
        check(not notes and all(st == ld == 0 for _, _, st, ld
                                in _build.ptxas_entries(name)),
              f"ptxas spilled or serialized wgmma in {name}.cu")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    profile = "--profile" in sys.argv[1:]
    kernels = [phase_attention(gen)]
    torch.cuda.empty_cache()
    kernels.append(phase_attention_bwd(gen))
    torch.cuda.empty_cache()
    kernels.append(phase_l2(gen))
    torch.cuda.empty_cache()
    t = time.perf_counter()
    kernels.append(phase_l2_rf(gen))
    print(f"l2_topk_rf phase {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    kernels.append(phase_l2_float(gen))
    print(f"l2_topk_float phase {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    probe_entry, probe_counts = phase_probe_mxu(gen)
    kernels.append(probe_entry)
    print(f"probe_mxu phase {time.perf_counter() - t:.1f} s")
    paths = {"probe_mxu": probe_counts}
    for name, phase in (("serving", phase_serving),
                        ("training", phase_training),
                        ("token_serving", phase_token_serving),
                        ("token_training", phase_token_training),
                        ("index", lambda _profile: phase_index(gen)),
                        ("int8", phase_int8),
                        ("cli", phase_cli),
                        ("interop", phase_interop),
                        ("convergence", phase_convergence)):
        torch.cuda.empty_cache()
        t = time.perf_counter()
        paths[name] = phase(profile)
        print(f"{name} phase {time.perf_counter() - t:.1f} s")
    for kern in kernels:
        # the model and index paths count the five model kernels; only the
        # probe tools launch int8_probe
        by_path = {p: c.get(kern["name"], 0) for p, c in paths.items()}
        kern["launches"] = sum(by_path.values())
        kern["launches_by_path"] = by_path
    print(f"total {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: kern[k] for k in keys},
         **({"by_shape": kern["by_shape"]} if "by_shape" in kern else {})}
        for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
