#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``rag_snvbert_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py              # what the checks need
    python3 chip_smoke.py --profile    # plus one request and one training
                                       # micro-step under torch.profiler

It builds the CUDA kernels from ``rag_snvbert_tpu_torch/csrc`` (one nvcc
per source, started together) and holds each kernel against its plain
PyTorch version at the main paths' shapes.  Then it drives these paths
with seeded random weights or data, each with the launch counts set to 0
just before it and read just after:
  - the int8 probe tools (``python -m rag_snvbert_tpu_torch.tools.probe_mxu``,
    ``probe_mxu2``, ``probe_mxu3``): every case at the genotype index shape
    (1024 x 664,648 x 2040, and 2048), each checked against the plain
    version and by its 64-bit sum of every product, beside ``_int_mm``;
    the int4 cases through the probe's int4 pack (of refs and of refs^T),
    held byte for byte against ``pack_int4_plain``;
  - V18 serving and training at the full ``tpu_default`` width (384d, 12
    layers, 3 heads of 128, L = 1030, a 2048-row window context): two
    imputation requests through ``ImputationService`` (batch 32), and one
    epoch of ``Trainer.fit`` (batch 24, gradient accumulation 2: four
    micro-steps, two updates, validation, a checkpoint and a restore);
  - V17 token-space serving and training at the full ``v17_token_rag``
    width (192d, 10 layers, 6 heads, L = 1030, float32, the same context
    size): two requests (batch 32) and one epoch of ``Trainer.fit``
    (batch 16, no accumulation);
  - ``remat`` (``phase_remat``): each mode at ``tpu_default`` width (batch
    24, residual dropout on) bit-identical to no remat under deterministic
    algorithms, with the attention forward launched again in the backward
    pass; ``tpu_scan`` through ``Trainer`` at the first batch of 128, 160,
    192 whose measured no-remat peak, extrapolated, exceeds the card (two
    micro-steps, an async checkpoint overlapping the second, ``finalize``
    and a restore); V17 training at batch 16 with ``True`` and
    ``"save_most"``; the alternative fusions at 384d against the CPU;
  - ``steps_per_dispatch`` (``phase_dispatch``): training chunks as CUDA
    graph replays, bit for bit against single steps under deterministic
    algorithms: V18 (batch 24, accumulation 2, K = 4: chunks of 4 and 1
    whose accumulation phase moves between windows), V17 (batch 8, K =
    4, ``l2_topk_rf`` inside the graphs), each remat mode,
    ``int8_matmuls`` and a one-rank NCCL mesh at K = 2; a gloo mesh is
    refused; K = 1 and K = 4 timed in turns (with ``--profile`` one chunk
    and the same steps one by one under torch.profiler);
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
  - ``tools/ab_compat.py``: one epoch of each variant (fixed, perdim,
    compat) at ``tpu_default`` width on one window of 48 samples and the
    2048-haplotype reference, each variant's launches checked;
    ``tools/sweep_topk.py`` at the genotype index shape, int8 and packed,
    over the default plan and three others (one of two waves): every plan
    bit-identical to the default and exact against the numpy oracle;
  - the scale-out path (``phase_distributed``): a one-rank NCCL world,
    then gloo worlds whose ranks share the card: dp2 x idx2 training, tp3
    serving (a head a rank), tp2 serving and training of ``tpu_default``
    and of its ``int8_matmuls`` twin (each rank's 192 columns split a
    head: the attention kernels run on the two whole heads a rank
    touches), dp2 imputation and the genotype index over two shards;
and checks the answers and the launch counts of each path.  V18 serving
also writes window 0's index and serves that window from it.  It prints
one JSON line of per-kernel numbers, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line; so does a machine without CUDA or a directory without
the package.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import gc
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
F32_FLOP_PER_S = 67e12          # float32 on the CUDA cores

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
# phase_remat: remat against no remat under deterministic algorithms is
# bit for bit (the recompute redraws the forward's dropout masks); the
# batch that only fits with remat is the first of these whose no-remat
# peak, extrapolated from two measured batches, exceeds the card; the
# alternative fusions on the card against the CPU at
# tests/test_torch_modules.py's float32 tolerance.
REMAT_BATCHES = (128, 160, 192)
REMAT_DIR = "runs/chip_smoke_remat"
FUSION_TOL = 1e-4
# The LayerNorm kernels (phase_layer_norm) at the training shape: 48
# sequences of 1030 tokens, the blocks' width and the FFN's.
RESIDUAL_SHAPES = ((48, 1030, 384), (64, 1030, 384))  # [2B, L, D]: 24, 32
LN_ROWS = 48 * 1030
LN_DIMS = (384, 1536)
LN_EPS = 1e-6
# The float32 attention kernels (phase_attention_f32) at upstream V18's
# training shape, batch 24 (48 sequences of 12 heads of 32), with the
# attention dropout 0.1; tolerances of tests/test_torch_cuda.py (float32
# sums of up to 1030 terms in other orders than the plain version's).
F32_ATTN_SHAPE = (48, 12, 1030, 32)
F32_ATTN_RATE = 0.1
F32_ATTN_TOL = {"o": 1e-5, "lse": 1e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
# The forward's parts a call, from the dropout's draws to o, at V18's shape
# and V17's (64 sequences of 6 heads), and what they were before the
# forward kernel compared the draws itself: the draw, the compare into a
# bool mask, its packing and the forward (device ms; NVIDIA H100 80GB HBM3,
# 700.00 W).
F32_PARTS_SHAPES = (F32_ATTN_SHAPE, (64, 6, 1030, 32))
F32_PARTS_BEFORE_MS = {
    F32_ATTN_SHAPE: {"draw": 0.9405, "compare": 0.9734, "pack": 0.3846,
                     "forward": 3.4042},
    (64, 6, 1030, 32): {"draw": 0.6256, "compare": 0.6483, "pack": 0.2542,
                        "forward": 2.2762}}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


BLOCK_KEYS = ("layer_norm", "layer_norm_bwd", "residual", "residual_bwd")


def block_want(counts: dict, forward: bool, backward: bool = False) -> dict:
    """The bf16 block kernels' entries (LayerNorm, the pre-LN residual
    epilogue) of a path's expected launch counts: some forward launches
    where the path runs a bf16 model, some backward ones where it trains
    one, none otherwise.  A path's exact numbers (one a bf16 LayerNorm
    call, two residual epilogues a pre-LN block) are held by
    tests/test_torch_cuda.py for a micro-step, by phase_training for a
    fit and by phase_layer_norm and phase_residual for a call."""
    return {key: counts[key] if (counts[key] > 0) == some
            else ("some" if some else 0)
            for key, some in zip(BLOCK_KEYS, (forward, backward) * 2)}


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
        # the kernel's name without "void ", namespaces, template
        # arguments or parameters (two instances of a template sum)
        key = re.sub(r"^void ", "", key).replace("(anonymous namespace)::",
                                                  "")
        return key.split("(")[0].split("<")[0].rsplit("::", 1)[-1][:60]

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = short(e.key)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 \
                / calls
    return out


def graph_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Mean device ms of a call of ``fn``: ``calls`` calls captured in one
    CUDA graph after a warm-up, its replays timed with CUDA events.  For
    calls whose host time exceeds their device time, where events around
    eager calls would time the host; the gaps between a graph's kernels
    (about a microsecond each) are counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del graph
    return ms


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


def _layer_norm_at(rows: int, d: int, gen) -> tuple[dict, dict]:
    """The LayerNorm kernels at rows x d against the plain chain (held to
    tests/test_torch_cuda.py's bounds), a rerun, and their times beside
    the byte bound, the plain chain and F.layer_norm on bf16 tensors."""
    import torch.nn.functional as F

    from rag_snvbert_tpu_torch.ops.layer_norm import (
        layer_norm_bwd, layer_norm_bwd_plain, layer_norm_fwd,
        layer_norm_plain)

    x = (torch.randn(rows, d, generator=gen, device="cuda") * 3 + 0.5).to(
        torch.bfloat16)
    w = torch.randn(d, generator=gen, device="cuda") * 0.2 + 1
    b = torch.randn(d, generator=gen, device="cuda") * 0.1
    dy = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
    y, mean, rstd = layer_norm_fwd(x, w, b, LN_EPS)
    dx, dg, db = layer_norm_bwd(dy, x, mean, rstd, w)
    torch.cuda.synchronize()
    ref = layer_norm_plain(x, w, b, LN_EPS).float()
    rdx, rdg, rdb = layer_norm_bwd_plain(dy, x, w, b, LN_EPS)
    rdx = rdx.float()
    y_err = (y.float() - ref).abs().max().item()
    dx_err = (dx.float() - rdx).abs().max().item()
    ok = bool(((y.float() - ref).abs() <= 2 ** -7 * ref.abs() + 1e-4).all()
              and ((dx.float() - rdx).abs() <= 2 ** -7 * rdx.abs()
                   + 1e-4 * rdx.abs().max()).all())
    xhat = (x.float() - mean[:, None]) * rstd[:, None]
    sums = []
    for got, want, terms in ((dg, rdg, dy.float() * xhat),
                             (db, rdb, dy.float())):
        tol = 2e-5 * terms.abs().sum(0) + 1e-6
        sums.append(((got - want).abs() / tol).max().item())
        del terms
    print(f"layer_norm [{rows}, {d}] bf16: y max_abs_err {y_err:.3e}, dx "
          f"{dx_err:.3e} against the plain chain; dgamma / dbeta at "
          f"{sums[0]:.3f} / {sums[1]:.3f} of their bound (2e-5 of the "
          f"terms' magnitudes)")
    check(ok and max(sums) <= 1.0, f"layer_norm kernels at [{rows}, {d}] "
          "disagree with the plain chain")
    again = (*layer_norm_fwd(x, w, b, LN_EPS),
             *layer_norm_bwd(dy, x, mean, rstd, w))
    check(all(torch.equal(a, c) for a, c in zip(
        (y, mean, rstd, dx, dg, db), again)),
          f"layer_norm runs at [{rows}, {d}] are not bit-identical")
    del ref, rdx, again, xhat

    def device_ms(fn):
        # every kernel the call launches, from the profiler: at 384 wide a
        # call's host time exceeds its device time, so events around
        # back-to-back calls would time the host
        return sum(kernel_ms(fn, 20).values())

    fwd = device_ms(lambda: layer_norm_fwd(x, w, b, LN_EPS))
    fwd_serve = device_ms(lambda: layer_norm_fwd(x, w, b, LN_EPS,
                                                 with_stats=False))
    split = kernel_ms(lambda: layer_norm_bwd(dy, x, mean, rstd, w), 20)
    bwd = sum(split.values())
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    y_plain = layer_norm_plain(*leaves, LN_EPS)
    plain_fwd = device_ms(lambda: layer_norm_plain(x, w, b, LN_EPS))
    plain_bwd = device_ms(lambda: torch.autograd.grad(
        y_plain, leaves, dy, retain_graph=True))
    del y_plain
    lib = [x.detach().requires_grad_(), w.bfloat16().requires_grad_(),
           b.bfloat16().requires_grad_()]
    y_lib = F.layer_norm(lib[0], (d,), lib[1], lib[2], LN_EPS)
    lib_fwd = device_ms(lambda: F.layer_norm(x, (d,), lib[1].detach(),
                                             lib[2].detach(), LN_EPS))
    lib_bwd = device_ms(lambda: torch.autograd.grad(
        y_lib, lib, dy, retain_graph=True))
    del y_lib
    # each input byte read once, each output byte written once: x in and y
    # out (and the statistics under autograd); dy and x in, dx out, the
    # statistics and gamma in, dgamma and dbeta out
    fwd_b = bound(rows * d * 4 + 2 * d * 4 + rows * 8, 0)[0]
    serve_b = bound(rows * d * 4 + 2 * d * 4, 0)[0]
    bwd_b = bound(rows * d * 6 + rows * 8 + 3 * d * 4, 0)[0]
    print(f"layer_norm [{rows}, {d}] (device ms of every kernel a call "
          f"launches): forward kernel_ms {fwd:.4f} "
          f"({fwd_b / fwd:.1%} of bound_ms {fwd_b:.4f}, bytes) plain_ms "
          f"{plain_fwd:.4f} library_ms {lib_fwd:.4f} (F.layer_norm, bf16); "
          f"without statistics {fwd_serve:.4f} ({serve_b / fwd_serve:.1%} "
          f"of {serve_b:.4f}); backward kernel_ms {bwd:.4f} ({bwd_b / bwd:.1%}"
          f" of bound_ms {bwd_b:.4f}, bytes) plain_ms {plain_bwd:.4f} "
          f"library_ms {lib_bwd:.4f} (F.layer_norm's backward, bf16); "
          f"backward by kernel {split}")
    shape = [rows, d]
    return ({"shape": shape, "max_abs_err": y_err, "ms": fwd,
             "ms_without_stats": fwd_serve, "plain_ms": plain_fwd,
             "bound_ms": fwd_b, "library_ms": lib_fwd},
            {"shape": shape, "max_abs_err": dx_err, "ms": bwd,
             "plain_ms": plain_bwd, "bound_ms": bwd_b, "library_ms": lib_bwd,
             "by_kernel": split})


def _layer_norm_host_us() -> dict[str, float]:
    """Host microseconds a call of a 384-wide bf16 LayerNorm module at 64
    rows (device work far below the host's), through the kernels and
    through the plain chain the module ran before them, without and with
    a gradient to record."""
    from rag_snvbert_tpu_torch.models.layers import LayerNorm
    from rag_snvbert_tpu_torch.ops.layer_norm import layer_norm_plain

    mod = LayerNorm(384, torch.bfloat16).cuda()
    x = torch.randn(64, 384, device="cuda").to(torch.bfloat16)
    xg = x.clone().requires_grad_()
    calls = {
        "kernel_no_grad": lambda: mod(x),
        "plain_no_grad": lambda: layer_norm_plain(x, mod.weight, mod.bias,
                                                  mod.eps),
        "kernel_grad": lambda: mod(xg),
        "plain_grad": lambda: layer_norm_plain(xg, mod.weight, mod.bias,
                                               mod.eps)}
    out = {}
    for name, fn in calls.items():
        with torch.set_grad_enabled(not name.endswith("no_grad")):
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(2000):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t) / 2000 * 1e6
    return out


def phase_layer_norm(gen) -> list[dict]:
    """The bf16 LayerNorm kernels at the training shape: 48 sequences of
    1030 tokens, the blocks' width 384 and the FFN's 1536; and a call's
    host time."""
    per = [_layer_norm_at(LN_ROWS, d, gen) for d in LN_DIMS]
    host = _layer_norm_host_us()
    print("layer_norm host us a call (384 wide, 64 rows): "
          + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
    entries = []
    for i, name in enumerate(("layer_norm", "layer_norm_bwd")):
        main = per[-1][i]              # the widest row: the largest share
        entries.append({
            "name": name, "route": "cuda",
            "source": "rag_snvbert_tpu_torch/csrc/layer_norm.cu",
            "replaces": "none (XLA's fused LayerNorm on the TPU)",
            "max_abs_err": max(p[i]["max_abs_err"] for p in per),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": main["library_ms"],
            "by_shape": [p[i] for p in per], "host_us": host})
    return entries


def _chain_bwd(g, f, masks, rates, leaky: bool) -> torch.Tensor:
    """The ops autograd runs for the gradient of f through the residual
    chain (``WhereBackward``, ``DivBackward``, ``LeakyReluBackward``), for
    timing it in a CUDA graph, which autograd's engine cannot be captured
    into here."""
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for keep, rate in reversed(list(zip(masks, rates))):
        g = torch.where(keep, g, zero) / (1.0 - rate)
    if leaky:
        g = torch.ops.aten.leaky_relu_backward(g, f, 0.1, False)
    return g


def _residual_at(shape, gen) -> list[dict]:
    """The residual epilogue kernels at ``shape`` against PyTorch's chain
    on the card, bit for bit, forward and backward (the kernels' forward
    and ``ResidualFn``'s gradients of x and f against the chain's
    autograd), for 0, 1 and 2 masks with and without LeakyReLU; and the
    device ms of each kernel call and of the chain it replaces beside
    the byte bound."""
    from rag_snvbert_tpu_torch.ops.residual import (
        residual, residual_bwd, residual_fwd, residual_plain)

    b, _, d = shape
    x, f, g = ((torch.randn(shape, generator=gen, device="cuda") * 2).to(
        torch.bfloat16) for _ in range(3))
    keeps = [torch.rand(b, 1, d, generator=gen, device="cuda") >= 0.1
             for _ in range(2)]
    act = x.numel() * 2                  # bytes of one bf16 activation
    out = []
    for n in (0, 1, 2):
        for leaky in (False, True):
            masks, rates = keeps[:n], [0.1] * n
            chain = residual_plain(x, f, masks, rates, leaky)
            same_fwd = torch.equal(residual_fwd(x, f, masks, rates,
                                                    leaky), chain)
            xg, fg, xc, fc = (t.detach().clone().requires_grad_()
                              for t in (x, f, x, f))
            got = torch.autograd.grad(residual(xg, fg, masks, rates, leaky),
                                      (xg, fg), g)
            y_chain = residual_plain(xc, fc, masks, rates, leaky)
            want = torch.autograd.grad(y_chain, (xc, fc), g)
            same_bwd = all(torch.equal(a, c) for a, c in zip(got, want))
            check(torch.equal(_chain_bwd(g, f, masks, rates, leaky), want[1]),
                  f"residual {list(shape)}: _chain_bwd is not the chain's "
                  "autograd")
            case = f"{list(shape)} {n} masks {'leaky' if leaky else 'id'}"
            check(same_fwd and same_bwd, f"residual {case}: the kernels "
                  f"differ from the chain (forward equal {same_fwd}, "
                  f"backward equal {same_bwd})")
            fwd = graph_ms(lambda: residual_fwd(x, f, masks, rates, leaky))
            chain_fwd = graph_ms(lambda: residual_plain(x, f, masks, rates,
                                                        leaky))
            row = {"shape": list(shape), "masks": n, "leaky": leaky,
                   "fwd_ms": fwd, "fwd_bound_ms": bound(3 * act + n * b * d,
                                                        0)[0],
                   "chain_fwd_ms": chain_fwd}
            if n or leaky:
                row["bwd_ms"] = graph_ms(lambda: residual_bwd(
                    g, f, masks, rates, leaky))
                row["bwd_bound_ms"] = bound((2 + leaky) * act + n * b * d,
                                            0)[0]
                row["chain_bwd_ms"] = graph_ms(lambda: _chain_bwd(
                    g, f, masks, rates, leaky))
            del y_chain, want, got
            print(f"residual {case}: bit-equal to the chain; fwd "
                  f"{row['fwd_ms']:.4f} ms ({row['fwd_bound_ms'] / row['fwd_ms']:.1%}"
                  f" of the bound), chain {chain_fwd:.4f} ms"
                  + (f"; bwd {row['bwd_ms']:.4f} ms "
                     f"({row['bwd_bound_ms'] / row['bwd_ms']:.1%}), chain "
                     f"{row['chain_bwd_ms']:.4f} ms" if "bwd_ms" in row
                     else ""))
            out.append(row)
    return out


def phase_residual(gen) -> list[dict]:
    """The residual epilogue kernels at the training shapes of batch 24
    and 32: the attention sublayer's call (one mask, no activation) and
    the FFN's (two masks, LeakyReLU), bit for bit against the chain, with
    their device times (row 11 of PERF.md's kernel table)."""
    rows = [r for shape in RESIDUAL_SHAPES for r in _residual_at(shape, gen)]
    main = [r for r in rows if r["shape"] == list(RESIDUAL_SHAPES[0])]
    ffn = next(r for r in main if r["masks"] == 2 and r["leaky"])
    attn = next(r for r in main if r["masks"] == 1 and not r["leaky"])
    entries = []
    for name, key in (("residual", "fwd"), ("residual_bwd", "bwd")):
        entries.append({
            "name": name, "route": "cuda",
            "source": "rag_snvbert_tpu_torch/csrc/residual.cu",
            "replaces": "none (XLA fuses the epilogue on the TPU)",
            "max_abs_err": 0.0, "ms": ffn[f"{key}_ms"],
            "plain_ms": ffn[f"chain_{key}_ms"],
            "bound_ms": ffn[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "by_shape": [{k: r[k] for k in r if k == "shape" or k == "masks"
                          or k == "leaky" or k.startswith(key)
                          or k.startswith(f"chain_{key}")}
                         for r in rows if f"{key}_ms" in r]})
    print(f"residual at {list(RESIDUAL_SHAPES[0])}: attention sublayer fwd "
          f"{attn['fwd_ms']:.4f} / bwd {attn['bwd_ms']:.4f} ms (chain "
          f"{attn['chain_fwd_ms']:.4f} / {attn['chain_bwd_ms']:.4f}), FFN "
          f"fwd {ffn['fwd_ms']:.4f} / bwd {ffn['bwd_ms']:.4f} ms (chain "
          f"{ffn['chain_fwd_ms']:.4f} / {ffn['chain_bwd_ms']:.4f})")
    return entries


def phase_attention_f32(gen) -> list[dict]:
    """The float32 attention kernels with dropout at F32_ATTN_SHAPE against
    their plain versions, a rerun, and their device times (every kernel a
    call launches: the forward from the dropout's draws, the row sums with
    the backward) beside the bound, the plain versions, the einsum path
    the model ran before them (with the same mask) and PyTorch's
    memory-efficient ``scaled_dot_product_attention`` in float32 with
    dropout 0.1 (a yardstick of time only: its dropout draws its own
    mask); then the forward's parts a call at F32_PARTS_SHAPES beside
    F32_PARTS_BEFORE_MS."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from rag_snvbert_tpu_torch.ops.attention_f32 import (
        attention_f32_bwd, attention_f32_bwd_plain, attention_f32_fwd,
        attention_f32_fwd_plain, pack_keep)

    b, h, l, hd = F32_ATTN_SHAPE
    rate, scale = F32_ATTN_RATE, hd ** -0.5
    q, k, v, do = (torch.randn(F32_ATTN_SHAPE, generator=gen, device="cuda")
                   for _ in range(4))
    # the model hands the forward the draws; the plain versions and the
    # einsum path take the bool mask they give
    draws = torch.rand(b, h, l, l, generator=gen, device="cuda")
    keep = draws >= rate
    out, lse, bits = attention_f32_fwd(q, k, v, scale, draws, rate)
    grads = attention_f32_bwd(q, k, v, out, lse, do, scale, bits, rate)
    torch.cuda.synchronize()
    check(torch.equal(bits, pack_keep(keep)), "the forward's bits from the "
          "draws are not the packed mask")
    ref, ref_lse = attention_f32_fwd_plain(q, k, v, scale, keep, rate)
    ref_grads = attention_f32_bwd_plain(q, k, v, ref, ref_lse, do, scale,
                                        keep, rate)
    errs, abs_errs = {}, {}
    for name, got, want in zip(F32_ATTN_TOL, (out, lse, *grads),
                               (ref, ref_lse, *ref_grads)):
        abs_errs[name] = (got - want).abs().max().item()
        errs[name] = abs_errs[name] / want.abs().max().item()
    del ref, ref_lse, ref_grads
    print(f"attention_f32 {list(F32_ATTN_SHAPE)} float32, dropout {rate}: "
          f"largest error over the largest value against the plain "
          f"versions {errs} (tol {F32_ATTN_TOL})")
    check(all(errs[n] <= t for n, t in F32_ATTN_TOL.items()),
          "the float32 attention kernels disagree with their plain versions")
    again = attention_f32_fwd(q, k, v, scale, draws, rate)
    again_grads = attention_f32_bwd(q, k, v, out, lse, do, scale, bits, rate)
    check(all(torch.equal(x, y) for x, y in zip(
        (out, lse, bits, *grads), (*again, *again_grads))),
          "float32 attention runs are not bit-identical")
    del again, again_grads

    def device_ms(fn, calls=5):
        split = kernel_ms(fn, calls)
        return sum(split.values()), split

    fwd, fwd_split = device_ms(
        lambda: attention_f32_fwd(q, k, v, scale, draws, rate))
    bwd, bwd_split = device_ms(
        lambda: attention_f32_bwd(q, k, v, out, lse, do, scale, bits, rate))
    plain_fwd = time_ms(lambda: attention_f32_fwd_plain(
        q, k, v, scale, keep, rate), 3, 1)
    plain_bwd = time_ms(lambda: attention_f32_bwd_plain(
        q, k, v, out, lse, do, scale, keep, rate), 3, 1)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def einsum(qq, kk, vv):
        # models/transformer.py::_core in float32, the mask given
        s = torch.matmul(qq, kk.transpose(-1, -2)) / torch.sqrt(
            torch.tensor(float(hd)))
        p = torch.softmax(s, dim=-1)
        return torch.matmul(torch.where(keep, p / (1.0 - rate),
                                        torch.zeros((), device="cuda")), vv)

    ein_fwd, _ = device_ms(lambda: einsum(q, k, v), 3)
    ein_both, _ = device_ms(lambda: torch.autograd.grad(
        einsum(*leaves), leaves, do), 3)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib_fwd, _ = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, dropout_p=rate, scale=scale), 3)
        lib_both, _ = device_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, dropout_p=rate,
                                           scale=scale), leaves, do), 3)
    ops_fwd, ops_bwd = (c * b * h * l * l * hd for c in (4, 10))
    # each input byte read once, each output byte written once: q, k, v in
    # and o out (and the LSE) at 4 bytes, the mask at a bit a score; the
    # backward q, k, v, o, do in and dq, dk, dv out, the LSE and the mask
    mask_b = b * h * l * l / 8
    fwd_b, fwd_by = bound(4 * b * h * l * hd * 4 + b * h * l * 4 + mask_b,
                          ops_fwd, F32_FLOP_PER_S)
    bwd_b, bwd_by = bound(8 * b * h * l * hd * 4 + b * h * l * 4 + mask_b,
                          ops_bwd, F32_FLOP_PER_S)
    print(f"attention_f32 {list(F32_ATTN_SHAPE)} (device ms of every kernel "
          f"a call launches): forward kernel_ms {fwd:.4f} ({fwd_b / fwd:.1%} "
          f"of bound_ms {fwd_b:.4f}, {fwd_by}; {ops_fwd / fwd / 1e9:.1f} "
          f"TFLOP/s) plain_ms {plain_fwd:.4f} einsum_ms {ein_fwd:.4f} "
          f"library_ms {lib_fwd:.4f} (SDPA efficient, float32, dropout "
          f"{rate}); backward kernel_ms {bwd:.4f} ({bwd_b / bwd:.1%} of "
          f"bound_ms {bwd_b:.4f}, {bwd_by}; {ops_bwd / bwd / 1e9:.1f} "
          f"TFLOP/s counted at 10 L^2 hd) plain_ms {plain_bwd:.4f}; forward "
          f"and backward {fwd + bwd:.4f} against the einsum path's "
          f"{ein_both:.4f} and SDPA's {lib_both:.4f}; forward by kernel "
          f"{fwd_split}, backward by kernel {bwd_split}")
    check(fwd < ein_fwd and fwd + bwd < ein_both, "the float32 attention "
          "kernels are not faster than the einsum path")
    del q, k, v, do, draws, keep, out, lse, bits, grads, leaves
    torch.cuda.empty_cache()
    for shape in F32_PARTS_SHAPES:
        parts = _attention_f32_fwd_parts(gen, shape, rate)
        before = F32_PARTS_BEFORE_MS[shape]
        print(f"attention_f32 forward's parts a call at {list(shape)} "
              f"(device ms): {parts} = {sum(parts.values()):.4f}; before "
              f"the forward compared the draws: {before} = "
              f"{sum(before.values()):.4f}")
    common = {"route": "cuda",
              "source": "rag_snvbert_tpu_torch/csrc/attention_f32.cu",
              "replaces": "none (the einsum path, "
                          "models/transformer.py::_core)",
              "shape": list(F32_ATTN_SHAPE)}
    return [{**common, "name": "attention_f32", "max_abs_err": abs_errs["o"],
             "ms": fwd, "plain_ms": plain_fwd, "bound_ms": fwd_b,
             "bound_by": fwd_by, "library_ms": lib_fwd, "einsum_ms": ein_fwd,
             "by_kernel": fwd_split},
            {**common, "name": "attention_f32_bwd",
             "max_abs_err": max(abs_errs[n] for n in ("dq", "dk", "dv")),
             "ms": bwd, "plain_ms": plain_bwd, "bound_ms": bwd_b,
             "bound_by": bwd_by, "library_ms": lib_both - lib_fwd,
             "einsum_ms": ein_both - ein_fwd, "by_kernel": bwd_split}]


def _attention_f32_fwd_parts(gen, shape, rate) -> dict[str, float]:
    """Device ms of each part of a training forward of the float32
    attention at ``shape``, from the dropout's draws to o: the draw
    (``torch.rand``) and the forward from the draws."""
    from rag_snvbert_tpu_torch.ops.attention_f32 import attention_f32_fwd

    b, h, l, hd = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))

    def draw():
        return torch.rand(b, h, l, l, generator=gen, device="cuda")

    draws = draw()
    parts = {"draw": sum(kernel_ms(draw).values()),
             "forward": sum(kernel_ms(lambda: attention_f32_fwd(
                 q, k, v, hd ** -0.5, draws, rate)).values())}
    del q, k, v, draws
    torch.cuda.empty_cache()
    return parts


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
    want = {"attention": 0, "attention_bwd": 0, "attention_f32": 0,
            "attention_f32_bwd": 0, "layer_norm": 0,
            "layer_norm_bwd": 0,
            "residual": 0, "residual_bwd": 0, "l2_topk": 0, "l2_topk_rf": 2 * 4,
            "l2_topk_float": 2 * 4}
    print(f"index launches {counts} (expected {want}: search, masked "
          f"search and the round trip's two searches, two storages each)")
    check(counts == want, "the index path did not go through its kernels")
    return counts


def _probe_edges(gen) -> float:
    """Every configuration of csrc/int8_probe.cu at the ragged shapes of
    PROBE_EDGE against the plain version: output and 64-bit sum exactly
    equal, the int4 pack of refs and of refs^T byte for byte, and the
    kernel's shared memory a stage as ops/int8_probe.py mirrors it.
    Returns the largest absolute difference (0)."""
    from rag_snvbert_tpu_torch.ops import _build
    from rag_snvbert_tpu_torch.ops import int8_probe as probe

    lib = _build.load("int8_probe", probe._SIGNATURES)
    for mode, tiles in probe.TILES.items():
        for tile in tiles:
            got = lib.int8_probe_stage_bytes(probe._MODES[mode], *tile)
            check(got == probe.stage_bytes(mode, tile),
                  f"int8_probe {mode} {tile}: stage of {got} bytes, "
                  f"stage_bytes says {probe.stage_bytes(mode, tile)}")
    worst, runs = 0, 0
    for b, n, d in PROBE_EDGE:
        q = torch.randint(-128, 128, (b, d), generator=gen, device="cuda",
                          dtype=torch.int8)
        r = torch.randint(-128, 128, (n, d), generator=gen, device="cuda",
                          dtype=torch.int8)
        rt = r.t().contiguous()
        for trans in (False, True):
            src = rt if trans else r
            same = torch.equal(probe.pack_int4(src, trans=trans),
                               probe.pack_int4_plain(src, trans=trans))
            check(same, f"int8_probe_pack_int4 trans={trans} at {(n, d)} "
                        "differs from pack_int4_plain")
        for mode, tiles in probe.TILES.items():
            for tile in tiles:
                for order in ("rfirst", "qfirst") if mode == "direct" \
                        else ("rfirst",):
                    # int4 takes refs and refs^T (the pack transposes)
                    for trans in ((False,) if mode == "direct" else
                                  (True,) if mode == "trans" else
                                  (False, True)):
                        kw = {"trans": trans, "int4": mode == "int4",
                              "running": mode != "direct"}
                        src = rt if trans else r
                        out, total = probe.int8_probe(
                            q, src, 8, 128, tile=tile, order=order,
                            return_checksum=True, **kw)
                        want, want_total = probe.int8_probe_plain(
                            q, src, 8, 128, return_checksum=True, **kw)
                        err = (out.long() - want.long()).abs().max().item()
                        worst = max(worst, err)
                        runs += 1
                        check(err == 0 and int(total) == int(want_total),
                              f"int8_probe {mode} {tile} {order} trans="
                              f"{trans} at {(b, n, d)}: max_abs_err {err}, "
                              f"sum {int(total)} vs {int(want_total)}")
    print(f"int8_probe: {runs} configurations x orders x layouts at "
          f"{PROBE_EDGE}: outputs and 64-bit sums equal to the plain "
          "version; pack_int4 of refs and refs^T equal to pack_int4_plain; "
          "stage bytes as stage_bytes")
    return float(worst)


def phase_probe_mxu(gen) -> tuple[list[dict], dict[str, int]]:
    """The int8 probe's path: the three probe tools (python -m
    rag_snvbert_tpu_torch.tools.probe_mxu{,2,3}) run every case at the
    index shape, each checked against the plain version and by its 64-bit
    sum inside the tool; the int4 pack of both layouts at probe_mxu3's
    shape against its plain version.  Returns the entries of int8_probe
    and of its int4 pack, and the launch counts."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.ops import int8_probe as probe
    from rag_snvbert_tpu_torch.tools import probe_mxu, probe_mxu2, probe_mxu3
    from rag_snvbert_tpu_torch.tools.probe_mxu import (
        B, D, HBM_BYTES_PER_S, N, bernoulli, bound_ms, time_ms)

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
    want = {**{k: 0 for k in counts},
            "int8_probe": sum(r["launches"] for r in cases),
            "int8_probe_pack_int4": sum(r.get("pack_launches", 0)
                                        for r in cases)}
    print(f"probe launches {counts} (expected {want})")
    packs = [r for r in rows["probe_mxu3"] if "pack_ms" in r]
    check(counts == want and all(r["launches"] > 0 for r in cases)
          and len(packs) == 2 and all(r["pack_launches"] > 0
                                      for r in packs),
          "the probe tools did not go through int8_probe and its int4 pack")
    main = next(r for r in rows["probe_mxu"]
                if r["variant"] == "pallas_mm_256x512x2048")
    lib = next(r for r in rows["probe_mxu"] if r["variant"] == "xla_int8")
    b_ms = bound_ms(B, N, D)
    print(f"int8_probe index shape [{B}, {D}] x [{N}, {D}]: kernel_ms "
          f"{main['ms']} ({main['cta_tile']}, kd {main['kd']}, rfirst) "
          f"plain_ms {main['plain_ms']} library_ms {lib['ms']} (_int_mm) "
          f"bound_ms {b_ms:.4f} (operations): {main['TOPs']} TOP/s, "
          f"{b_ms / main['ms']:.1%} of the bound, "
          f"{main['ms'] / lib['ms']:.3f}x the library call")
    d3 = probe_mxu3.D
    b3 = bound_ms(B, N, d3)
    for r in rows["probe_mxu3"]:
        if "cta_tile" in r:
            pack = r.get("pack_ms")
            print(f"probe_mxu3 {r['variant']} ({r['cta_tile']}): kernel_ms "
                  f"{r['ms']} (the whole call), pack_ms "
                  f"{pack if pack is not None else '-'}, "
                  f"{r['pct_of_bound']}% of the {b3:.4f} ms bound; "
                  f"plain_ms {r['plain_ms']}")
    # the int4 pack at probe_mxu3's shape: refs^T (the transposed pass, the
    # entry's time) and refs, against its plain version on the same inputs
    refs = bernoulli((N, d3), 0)
    pack_rows = {}
    for trans in (True, False):
        src = refs.t().contiguous() if trans else refs
        same = torch.equal(probe.pack_int4(src, trans=trans),
                           probe.pack_int4_plain(src, trans=trans))
        check(same, f"int8_probe_pack_int4 trans={trans} at the index shape "
                    "differs from pack_int4_plain")
        ms = time_ms(lambda: probe.pack_int4(src, trans=trans))
        plain = time_ms(lambda: probe.pack_int4_plain(src, trans=trans))
        moved = N * d3 + N * 16 * -(-d3 // 32)
        pack_rows[trans] = {
            "variant": "refs_t" if trans else "refs", "ms": round(ms, 4),
            "plain_ms": round(plain, 4),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}
        print(f"int8_probe_pack_int4 {pack_rows[trans]['variant']} [{N}, "
              f"{d3}]: kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
              f"{pack_rows[trans]['bound_ms']:.4f} (bytes: {moved / 1e9:.2f} "
              "GB read once and written once at 3.35 TB/s), equal to the "
              "plain version")
        del src
    del refs
    torch.cuda.empty_cache()
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
    pack_entry = {"name": "int8_probe_pack_int4", "route": "cuda",
                  "source": "rag_snvbert_tpu_torch/csrc/int8_probe.cu",
                  "replaces": "tools/probe_mxu3.py:58",
                  "max_abs_err": 0.0,
                  "ms": pack_rows[True]["ms"],
                  "plain_ms": pack_rows[True]["plain_ms"],
                  "bound_ms": pack_rows[True]["bound_ms"],
                  "bound_by": "bytes", "library_ms": None,
                  "by_shape": list(pack_rows.values())}
    return [entry, pack_entry], counts


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
            "attention_bwd": 0, "attention_f32": 0, "attention_f32_bwd": 0,
            **block_want(counts, True),
            "l2_topk": batches * len(targets), "l2_topk_rf": 0,
            "l2_topk_float": 0}
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
    # in plain torch math and the plain search (no attention or search
    # launches; its bf16 LayerNorms run the LayerNorm kernels, as the
    # kernel path's do).
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
    after = ops.launch_counts()
    check(all(after[k] == before[k] for k in after if k not in BLOCK_KEYS)
          and after["layer_norm"] > before["layer_norm"],
          f"the plain path launched an attention or search kernel, or no "
          f"LayerNorm kernel: {before} -> {after}")
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
            * micro, "attention_f32": 0, "attention_f32_bwd": 0,
            **block_want(by_verb["train"], True, True),
            "l2_topk": micro, "l2_topk_rf": 0, "l2_topk_float": 0}
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
            "attention_f32": 0, "attention_f32_bwd": 0,
            **block_want(by_verb["infer"], True), "l2_topk": batches,
            "l2_topk_rf": 0, "l2_topk_float": 0}
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
            "attention_f32": 0, "attention_f32_bwd": 0,
            **block_want(by_verb["serve"], True), "l2_topk": 2 * batches,
            "l2_topk_rf": 0, "l2_topk_float": 0}
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
          and h["attention_bwd"] == 0 and h["layer_norm"] > 0
          and h["layer_norm_bwd"] == 0, "HTTP serving did not go through "
          "the attention, LayerNorm and l2_topk kernels")
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
    (attention dropout 0.1, so the float32 attention kernels, and
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
        with _eager_imputers():
            cli(["infer", "--target", at("target.vcf"), "--output_vcf",
                 at("infer.vcf"), "--npy_prefix", at("infer"), *model_args])
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t
    finally:
        retrieval.search = real_search
    counts["infer"] = ops.launch_counts()
    want = {"attention": 0, "attention_bwd": 0,
            "attention_f32": m.n_layers * batches, "attention_f32_bwd": 0,
            "layer_norm": 0, "layer_norm_bwd": 0,
            "residual": 0, "residual_bwd": 0, "l2_topk": batches,
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
    want = {"attention": 0, "attention_bwd": 0,
            "attention_f32": m.n_layers * 2,
            "attention_f32_bwd": m.n_layers * 2, "layer_norm": 0,
            "layer_norm_bwd": 0,
            "residual": 0, "residual_bwd": 0, "l2_topk": 2, "l2_topk_rf": 0,
            "l2_topk_float": 0}
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
            "attention_f32": 0, "attention_f32_bwd": 0,
            **block_want(counts, True, True), "l2_topk": 2 * (micro + val),
            "l2_topk_rf": 0, "l2_topk_float": 0}
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


AB_DIR = "runs/chip_smoke_ab_compat"
AB_ARGV = ["--epochs", "1", "--windows", "1", "--train-samples", "48",
           "--ref-samples", "1024", "--variants", "fixed,perdim,compat",
           "--val-frac", "0.25"]
AB_KEYS = ["variant", "epochs", "best_val_hap_f1", "best_epoch",
           "final_val_hap_f1", "final_val_rare_f1", "final_train_loss",
           "wall_min"]
SWEEP_CHUNKS = 2


def phase_ab_compat(profile: bool = False) -> dict[str, int]:
    """tools/ab_compat.py at tpu_default width, cut to one epoch of one
    window and 48 samples (the full 2048-haplotype reference): three rows
    with the JAX tool's keys, and each variant's launches against the
    counts worked out from the code: fixed and perdim through the
    attention kernels, compat (attention dropout) through the einsum path,
    every variant through l2_topk."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import PRESETS
    from rag_snvbert_tpu_torch.tools import ab_compat

    cfg = PRESETS["tpu_default"]
    card = card_line()
    shutil.rmtree(AB_DIR, ignore_errors=True)
    per: dict[str, dict[str, int]] = {}
    seconds: dict[str, float] = {}
    run_variant = ab_compat.run_variant

    def counted(run, ds, ids, args, name):
        torch.cuda.synchronize()
        before, t = ops.launch_counts(), time.perf_counter()
        row = run_variant(run, ds, ids, args, name)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        per[name] = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return row

    ops.reset_launches()
    ab_compat.run_variant = counted
    try:
        rows = ab_compat.main(AB_ARGV + ["--outdir", AB_DIR])
    finally:
        ab_compat.run_variant = run_variant
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    m = cfg.model.n_layers
    n_val = int(48 * 0.25)
    micro = -(-(48 - n_val) // cfg.batch_size)
    val = -(-n_val // cfg.val_batch_size)
    want = {}
    for name in ("fixed", "perdim", "compat"):
        # one epoch: a forward a layer and a search a step (both
        # haplotypes in one launch), a backward a layer a micro-step; two
        # residual epilogues a pre-LN block through the kernels, where
        # the masks lie along the sequence (fixed) or there are none
        # (validation; perdim's mask a position takes the chain in
        # training); compat is post-LN
        kernels = name != "compat"
        res_fwd = {"fixed": micro + val, "perdim": val, "compat": 0}[name]
        want[name] = {"attention": m * (micro + val) * kernels,
                      "attention_bwd": m * micro * kernels,
                      "attention_f32": 0, "attention_f32_bwd": 0,
                      **block_want(per[name], True, True),
                      "residual": 2 * m * res_fwd,
                      "residual_bwd": 2 * m * micro * (name == "fixed"),
                      "l2_topk": micro + val, "l2_topk_rf": 0,
                      "l2_topk_float": 0}
        print(f"ab_compat {name}: {seconds[name]:.1f} s for one epoch "
              f"({micro} micro-steps, {val} validation step); launches "
              f"{per[name]} (expected {want[name]}); {card}")
    for row in rows:
        print(f"  {json.dumps(row)}")
    check([r["variant"] for r in rows] == ["fixed", "perdim", "compat"]
          and all(list(r) == AB_KEYS for r in rows),
          "ab_compat rows lack the JAX tool's keys")
    check(all(0.0 <= r[f] <= 1.0 for r in rows
              for f in ("best_val_hap_f1", "final_val_hap_f1",
                        "final_val_rare_f1"))
          and all(math.isfinite(r["final_train_loss"]) for r in rows),
          "ab_compat F1 outside [0, 1] or a loss not finite")
    check(per == want, "ab_compat did not launch the kernels its variants "
          "take")
    return counts


def phase_sweep_topk(profile: bool = False) -> dict[str, int]:
    """tools/sweep_topk.py at the genotype index shape (664,648 x 2040,
    1024-query batches, k = 10), int8 and packed, over the default plan,
    half its rows (two waves of blocks) and a two-stage ring: every plan
    bit-identical to the default and exact against the numpy oracle on 128
    queries."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.ops.l2_topk_rf import _BN, row_classes
    from rag_snvbert_tpu_torch.tools import sweep_topk

    card = card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops.reset_launches()
    n_plans = 0
    for dtype, pack in (("int8", 1), ("packed", 8)):
        classes = row_classes(2040 if pack == 1 else 256, sweep_topk.N_ROWS,
                              pack, True)
        rows0, _ = sweep_topk.default_plan(sweep_topk.BATCH,
                                           sweep_topk.N_ROWS, sweep_topk.K,
                                           pack, classes, sms)
        half = -(-(rows0 // 2) // _BN) * _BN
        argv = ["--dtype", dtype, "--chunks", str(SWEEP_CHUNKS), "--rows",
                f"{rows0},{half}", "--stages", "4,2"]
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rows = sweep_topk.main(argv)
        took = time.perf_counter() - t
        n_plans += len(rows)
        print(f"sweep_topk {dtype}: {len(rows)} plans in {took:.1f} s "
              f"({SWEEP_CHUNKS} chunks of 1024 queries); {card}")
        for r in rows:
            print(f"  rows {r['rows']} ({r['splits']} splits, {r['waves']} "
                  f"wave(s)) stages {r['stages']}: {r['ms_per_batch']:.4f} "
                  f"ms a batch, {r['qps']:.1f} qps; equal to the default "
                  f"{r['ids_equal_default']}, exact against the oracle "
                  f"{r['oracle_exact']}")
        check(all(r["ids_equal_default"] and r["oracle_exact"]
                  for r in rows) and max(r["waves"] for r in rows) > 1,
              f"sweep_topk {dtype}: a plan disagrees, or none took two "
              "waves")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # a dtype: one pass of the default plan (what every plan is held to),
    # then each plan one pass to check it and two timed passes
    want = {"attention": 0, "attention_bwd": 0, "attention_f32": 0,
            "attention_f32_bwd": 0, "layer_norm": 0,
            "layer_norm_bwd": 0,
            "residual": 0, "residual_bwd": 0, "l2_topk": 0,
            "l2_topk_rf": SWEEP_CHUNKS * (2 + 3 * n_plans),
            "l2_topk_float": 0}
    print(f"sweep_topk launches {counts} (expected {want})")
    check(counts == want, "sweep_topk did not go through l2_topk_rf")
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
                    **block_want(counts, True), "l2_topk": 2 * batches}
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
                    **block_want(train, True, True), "l2_topk": steps + 2}
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
    test_optimizer_matches_optax pins on the CPU), with optax ``adamw``'s
    decoupled decay ``wd * p`` added to the Adam direction."""
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
        if opt.weight_decay:
            u = u + p * opt.weight_decay
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
          f"{opt.clip_norm}, weight decay {opt.weight_decay}), multi-tensor "
          f"against per-tensor on the card, bit for bit: {same}")
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
            "attention_bwd": m.n_layers * micro, "attention_f32": 0,
            "attention_f32_bwd": 0,
            **block_want(counts, True, True), "l2_topk": micro + val_steps,
            "l2_topk_rf": 0, "l2_topk_float": 0,
            # two residual epilogues a pre-LN block, each with its masks
            # in training (a backward launch each), none in validation
            "residual": 2 * m.n_layers * (micro + val_steps),
            "residual_bwd": 2 * m.n_layers * micro}
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
    # optax adamw's decoupled weight decay, from a copy of the trained state
    decay = Optimizer([(n, p.detach().clone()) for n, p in
                       zip(opt.names, opt.params)], accum_steps=2,
                      weight_decay=0.01)
    for key in ("mu", "nu"):
        for dst, src in zip(getattr(decay, key), getattr(opt, key)):
            dst.copy_(src)
    decay.count = opt.count
    _optimizer_check(decay, grad_scale=1e-2, clipped=True)
    del decay

    # (iii) one batch, dropout off: the kernel path against the plain path
    # on the card (same weights: attention in plain torch math with float32
    # scores, the plain search; no attention or search launches).  Both
    # paths run the bf16 LayerNorm kernels.
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
                  "attention_f32": 0, "attention_f32_bwd": 0,
                  **block_want(one, True, True), "l2_topk": 1, "l2_topk_rf": 0,
                  "l2_topk_float": 0},
          f"kernel path launches {one}")
    del model
    model = build_model(plain_cfg, bundle.vocab.size, seed=0)
    model.load_state_dict(state)
    ops.reset_launches()
    p_loss, p_grads = _grads_of_one_batch(model, batch, ctx_of, False)
    plain = ops.launch_counts()
    check(not any(v for k, v in plain.items() if k not in BLOCK_KEYS)
          and plain["layer_norm"] == one["layer_norm"]
          and plain["layer_norm_bwd"] == one["layer_norm_bwd"],
          f"the plain path launched an attention or search kernel: {plain}")
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


@contextlib.contextmanager
def _eager_imputers():
    """Imputers made inside (by the CLI, where no instance is at hand) run
    ``_forward`` eagerly: a recorder that reads each batch's retrieval back
    cannot sit inside a CUDA graph capture (and a replay would not call
    it)."""
    from rag_snvbert_tpu_torch.infer.imputer import Imputer

    real = Imputer.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.use_graphs = False

    Imputer.__init__ = init
    try:
        yield
    finally:
        Imputer.__init__ = real


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
    want = {"attention": 0, "attention_bwd": 0,
            "attention_f32": m.n_layers * batches * len(targets),
            "attention_f32_bwd": 0, "layer_norm": 0,
            "layer_norm_bwd": 0,
            "residual": 0, "residual_bwd": 0, "l2_topk": 0,
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
            imp = Imputer(model, _drop(bundle.ref, sites), bundle.freq,
                          batch_size=32, rag_mode="token",
                          use_kernel=use_kernel)
            imp.use_graphs = False    # the recorder sees every batch
            res = imp.impute(_drop(target, sites[keep]))
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
    want = {"attention": 0, "attention_bwd": 0,
            "attention_f32": m.n_layers * (micro + val_steps),
            "attention_f32_bwd": m.n_layers * micro, "layer_norm": 0,
            "layer_norm_bwd": 0,
            "residual": 0, "residual_bwd": 0, "l2_topk": 0,
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


def _train_bundle(n_samples: int):
    """phase_training's bundle (2008 reference haplotypes, two windows of
    1020 sites) with ``n_samples`` training samples."""
    from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle

    bundle = make_bundle(n_train_samples=n_samples, n_ref_samples=1004,
                         n_sites=2 * 1020, n_windows=2, seed=23)
    return bundle, WindowDataset(bundle.train, bundle.panel, bundle.freq,
                                 bundle.window.window_info, bundle.vocab,
                                 ref_vcf=bundle.ref, seq_len=1030)


def _remat_run(cfg, vocab: int, batch, ctx_of, timed: int = 5,
               profile: str | None = None) -> dict:
    """A fresh model of ``cfg`` (seed 0, its dropout on): under
    deterministic algorithms one micro-step with step 0's generator and an
    update (accumulation 1, the preset's peak lr): its loss, gradients,
    generator state after backward, the parameters after the update and
    the launch counts; then ``timed`` warm micro-steps (the default,
    non-deterministic algorithms) with their median ms and the peak device
    memory, in all and above what was resident before them.  ``profile``
    (a label): two more micro-steps under torch.profiler, printed."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import build_model
    from rag_snvbert_tpu_torch.models.layers import set_dropout_generator
    from rag_snvbert_tpu_torch.train import step
    from rag_snvbert_tpu_torch.train.schedule import make_optimizer

    model = build_model(cfg, vocab, seed=0)
    dev = next(model.parameters()).device
    ctx = ctx_of(model)
    opt = make_optimizer(model, cfg.max_lr, cfg.max_lr, 1)
    out = {}
    with _deterministic():
        ops.reset_launches()
        model.train()
        gen = step.step_generator(0, 0, dev)
        set_dropout_generator(model, gen)
        loss, _, _ = step._forward(model, batch, ctx, step.StepConfig())
        loss.backward()
        set_dropout_generator(model, None)
        # kept on the host, so that every mode's timed steps below start
        # from the same resident device memory
        out["loss"] = loss.detach().cpu()
        out["grads"] = [p.grad.detach().cpu() for p in opt.params]
        out["gen"] = gen.get_state()
        opt.step()
        opt.zero_grad()
        torch.cuda.synchronize()
        out["launches"] = ops.launch_counts()
        out["params"] = [p.detach().cpu() for p in opt.params]
    times = []
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for i in range(timed + 1):
        gen = step.step_generator(0, 100 + i, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step.train_step(model, opt, batch, ctx, step.StepConfig(), gen)
        torch.cuda.synchronize()
        if i:                               # the first one warms up
            times.append(time.perf_counter() - t)
    _add(out["launches"], ops.launch_counts())
    out["ms"] = statistics.median(times) * 1e3
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["act_gb"] = (torch.cuda.max_memory_allocated() - resident) / 1e9
    if profile:
        from torch.profiler import ProfilerActivity, profile as trace

        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(2):
                step.train_step(model, opt, batch, ctx, step.StepConfig(),
                                step.step_generator(0, 200 + i, dev))
            torch.cuda.synchronize()
        _print_profile(f"{profile}, two micro-steps", prof,
                       (time.perf_counter() - t) * 1e3)
    del model, opt, ctx
    torch.cuda.empty_cache()
    return out


def _same_run(got: dict, ref: dict) -> dict[str, bool]:
    return {"loss": torch.equal(got["loss"], ref["loss"]),
            "grads": all(torch.equal(a, b) for a, b in
                         zip(got["grads"], ref["grads"])),
            "generator": torch.equal(got["gen"], ref["gen"]),
            "params": all(torch.equal(a, b) for a, b in
                          zip(got["params"], ref["params"]))}


def _fusions_on_the_card() -> None:
    """The four alternative fusions and ``pos_norm="none"`` at 384d (L =
    1030, K = 2) on the card against the same modules on the CPU, float32
    (TF32 off), within FUSION_TOL relative and absolute."""
    from rag_snvbert_tpu_torch.models import fusion
    from rag_snvbert_tpu_torch.models.layers import init_weights

    g = torch.Generator().manual_seed(31)
    b, k, n, d = 2, 2, 1030, 384
    orig, rag = torch.randn(b, n, d, generator=g), \
        torch.randn(b, k, n, d, generator=g)
    af, pos = torch.rand(b, n, generator=g), torch.rand(b, n, generator=g)
    cases = {
        "RareVariantAwareFusion": (fusion.RareVariantAwareFusion(d),
                                   (orig, rag, af)),
        "FixedConcatFusion": (fusion.FixedConcatFusion(d), (orig, rag)),
        "ConcatFusion": (fusion.ConcatFusion(d), (orig, rag)),
        "CrossAttentionFusion": (fusion.CrossAttentionFusion(d), (orig, rag)),
        "PositionFeatModule(none)": (fusion.PositionFeatModule(norm="none"),
                                     (pos,)),
        "EmbeddingFusionModule(pos_norm=none)": (
            fusion.EmbeddingFusionModule(d, pos_norm="none"),
            (orig, pos, af)),
    }
    errs = {}
    for i, (name, (mod, args)) in enumerate(cases.items()):
        init_weights(mod, seed=40 + i)
        with torch.no_grad():
            want = mod(*args)
            got = copy.deepcopy(mod).cuda()(*(a.cuda() for a in args)).cpu()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        errs[name] = err
        check(got.shape == want.shape and bool(torch.isfinite(got).all())
              and torch.allclose(got, want, rtol=FUSION_TOL, atol=FUSION_TOL),
              f"{name} on the card differs from the CPU: max |diff| {err:.2e}"
              f" (output scale {scale:.3g})")
    print("alternative fusions and pos_norm='none' at 384d, card against "
          "CPU, float32: max |diff| "
          + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + f" (tol {FUSION_TOL} relative and absolute)")


def phase_remat(profile: bool = False) -> dict[str, int]:
    """The model and trainer surface of remat: (1) each ``remat`` mode at
    ``tpu_default`` width, batch 24, residual dropout on, bit-identical to
    no remat under deterministic algorithms, with the attention forward's
    recompute in the launch counts, peaks and step times; (2) ``tpu_scan``
    through ``Trainer`` at a batch whose no-remat peak (extrapolated from
    two measured batches) exceeds the card: two micro-steps, one update,
    an async checkpoint overlapping the second, ``finalize`` and an exact
    restore; (3) V17 token training at batch 16 with ``True`` and
    ``"save_most"`` against no remat; (4) the alternative fusions."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.models.transformer import REMAT_MODES
    from rag_snvbert_tpu_torch.train import step
    from rag_snvbert_tpu_torch.train.retrieval import (build_token_window_ctx,
                                                       encode_window_refs)
    from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig

    counts: dict[str, int] = {}
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    base = PRESETS["tpu_default"]
    m = base.model
    bundle, ds = _train_bundle(48)
    vocab = bundle.vocab.size
    meta = ds.windows[0]

    def put(b: int):
        return {k: torch.from_numpy(v).cuda() for k, v in ds.make_batch(
            meta, np.arange(b) % ds.n_samples, 0, 0, packed=True).items()}

    def v18_ctx(model):
        model.eval()
        toks, af, valid = (torch.from_numpy(x).cuda() for x in
                           ds.window_ref_tokens(meta, pad_haps_to=2048))
        wmask = torch.from_numpy(ds.window_mask(meta, 0, 0)).cuda()
        with torch.no_grad():
            return encode_window_refs(model.embed, toks.long(), af, wmask,
                                      valid=valid)

    # (1) every mode at batch 24 (tpu_scan is remat=True), and no remat at
    # batch 12 for the per-sample slope of the peak
    batch = put(base.batch_size)
    runs = {}
    for mode in REMAT_MODES:
        cfg = (PRESETS["tpu_scan"] if mode is True else
               dataclasses.replace(base, model=dataclasses.replace(
                   m, remat=mode)))
        runs[mode] = _remat_run(cfg, vocab, batch, v18_ctx,
                                profile=profile and f"remat={mode!r}")
        _add(counts, runs[mode]["launches"])
    half = _remat_run(base, vocab, put(base.batch_size // 2), v18_ctx,
                      timed=1)
    _add(counts, half["launches"])
    ref = runs[False]
    for mode, r in runs.items():
        same = _same_run(r, ref)
        want_fwd = m.n_layers * (1 if mode in (False, "save_most") else 2)
        print(f"remat={mode!r} (batch {base.batch_size}, dropout "
              f"{m.dropout}): loss {r['loss'].item():.6f}; bit-identical to "
              f"remat=False: {same}; launches over its 7 micro-steps "
              f"{ {k: v for k, v in r['launches'].items() if v} }; micro-"
              f"step median {r['ms']:.1f} ms; peak device memory "
              f"{r['peak_gb']:.2f} GB ({r['act_gb']:.2f} GB above the "
              "resident model, optimizer and context)")
        check(all(same.values()), f"remat={mode!r} changed the loss, a "
              "gradient, the generator or the update")
        # the deterministic step, the warm-up and the 5 timed ones
        # the residual epilogues are recomputed where the whole block is
        want_res = 2 * m.n_layers * (2 if mode in (True, "save_ffn") else 1)
        check(r["launches"]["attention"] == 7 * want_fwd
              and r["launches"]["attention_bwd"] == 7 * m.n_layers
              and r["launches"]["l2_topk"] == 7
              and r["launches"]["residual"] == 7 * want_res
              and r["launches"]["residual_bwd"] == 7 * 2 * m.n_layers,
              f"remat={mode!r}: attention forward launches "
              f"{r['launches']['attention']}, expected {7 * want_fwd}; "
              f"residual {r['launches']['residual']} / "
              f"{r['launches']['residual_bwd']}, expected {7 * want_res} / "
              f"{7 * 2 * m.n_layers}")
    for mode in (True, "save_ffn", "attention"):
        check(runs[mode]["peak_gb"] < ref["peak_gb"],
              f"remat={mode!r} did not lower the peak")
    slope = (ref["peak_gb"] - half["peak_gb"]) / (base.batch_size
                                                  - base.batch_size // 2)
    card_gb = card_bytes / 1e9
    fits = [b for b in REMAT_BATCHES
            if ref["peak_gb"] + slope * (b - base.batch_size) > card_gb]
    check(bool(fits), f"no batch of {REMAT_BATCHES} exceeds the card "
          f"({card_gb:.1f} GB) without remat at {slope:.3f} GB a sample")
    big = fits[0]
    noremat_gb = ref["peak_gb"] + slope * (big - base.batch_size)
    print(f"no-remat peak {half['peak_gb']:.2f} GB at batch "
          f"{base.batch_size // 2}, {ref['peak_gb']:.2f} GB at "
          f"{base.batch_size}: {slope:.3f} GB a sample; at batch {big} it "
          f"would be {noremat_gb:.1f} GB against the card's {card_gb:.1f} GB")
    del runs, half, ref, batch
    torch.cuda.empty_cache()

    # (2) tpu_scan through Trainer at that batch: micro-step, async save,
    # micro-step (the update) while the writer writes, finalize, restore
    cfg = PRESETS["tpu_scan"]
    shutil.rmtree(REMAT_DIR, ignore_errors=True)
    tcfg = TrainerConfig(epochs=1, batch_size=big, init_lr=cfg.max_lr,
                         max_lr=cfg.max_lr, warmup_steps=1,
                         grad_accum_steps=2, ref_pad_haps=2048,
                         output_dir=REMAT_DIR, seed=0)
    trainer = Trainer(build_model(cfg, vocab, seed=0), ds, tcfg)
    opt = trainer.optimizer
    batch = put(big)
    ctx = trainer._window_ctx(ds, meta, 0, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    times = []

    def micro(i):
        gen = step.step_generator(0, i, trainer.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step.train_step(trainer.model, opt, batch, ctx, trainer.step_cfg,
                        gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        trainer.step += 1

    micro(0)
    snap_params = {k: v.clone() for k, v in
                   trainer.model.state_dict().items()}
    snap_opt = copy.deepcopy(opt.state_dict())
    t = time.perf_counter()
    trainer.save_checkpoint(0, is_best=False)
    call_s = time.perf_counter() - t
    writing = trainer._saver is not None and trainer._saver.is_alive()
    micro(1)
    overlapped = trainer._saver is not None and trainer._saver.is_alive()
    t = time.perf_counter()
    trainer.finalize()
    join_s = time.perf_counter() - t
    counts_big = ops.launch_counts()
    # the same save written in place, for the per-epoch arithmetic
    trainer.cfg.async_checkpoints = False
    t = time.perf_counter()
    trainer.save_checkpoint(1, is_best=False)
    sync_s = time.perf_counter() - t
    _add(counts, counts_big)
    peak_big = torch.cuda.max_memory_allocated() / 1e9
    moved = sum(not torch.equal(snap_params[n], p)
                for n, p in trainer.model.state_dict().items())
    size_mb = os.path.getsize(os.path.join(REMAT_DIR, "ckpt_ep0",
                                           "state.pt")) / 1e6
    print(f"tpu_scan through Trainer at batch {big} (accumulation 2, "
          f"L {m.seq_len}): micro-steps {[round(x * 1e3, 1) for x in times]}"
          f" ms, {big / statistics.mean(times):.1f} training samples/s; "
          f"peak device memory {peak_big:.2f} GB (no remat: "
          f"{noremat_gb:.1f} GB extrapolated, the card {card_gb:.1f} GB); "
          f"launches {counts_big}; async checkpoint of {size_mb:.1f} MB: "
          f"{call_s:.2f} s on the calling thread (gather + host copy), "
          f"writer still writing when micro-step 2 started {writing} and "
          f"when it ended {overlapped}, finalize waited {join_s:.2f} s; "
          f"the same save written in place {sync_s:.2f} s")
    check(peak_big < card_gb and noremat_gb > card_gb,
          "the remat batch does not show a batch that fits only with remat")
    check(counts_big["attention"] == 2 * 2 * m.n_layers
          and counts_big["attention_bwd"] == 2 * m.n_layers
          and counts_big["l2_topk"] == 2,
          f"tpu_scan at batch {big}: launches {counts_big}")
    check(opt.count == 1 and moved > 0,
          "the second micro-step did not update the parameters")
    check(all(np.isfinite(x) for x in times), "non-finite step time")
    fresh = Trainer(build_model(cfg, vocab, seed=1), ds, tcfg)
    fresh.restore_checkpoint(os.path.join(REMAT_DIR, "ckpt_ep0"))
    same = all(torch.equal(fresh.model.state_dict()[n], v)
               for n, v in snap_params.items())
    b_opt = fresh.optimizer.state_dict()
    same_opt = (snap_opt["count"], snap_opt["mini_step"]) == (
        b_opt["count"], b_opt["mini_step"]) and all(
        torch.equal(snap_opt[key][n], b_opt[key][n])
        for key in ("mu", "nu", "acc") for n in snap_opt[key])
    print(f"restore of the async checkpoint: parameters equal the state at "
          f"the save {same}, optimizer state {same_opt} (mini_step "
          f"{b_opt['mini_step']}, count {b_opt['count']}), step "
          f"{fresh.step}")
    check(same and same_opt and fresh.step == 1,
          "the async checkpoint does not hold the state at the save")
    del trainer, fresh, opt, batch, ctx, snap_params, snap_opt
    torch.cuda.empty_cache()

    # (3) V17 token training at batch 16 (float32, attention dropout 0.1:
    # the float32 attention kernels, which store no [B, H, L, L] core, so
    # "save_most" stores what no remat does)
    tcfg17 = PRESETS["v17_token_rag"]
    tbundle, tds = _train_bundle(32)
    tmeta = tds.windows[0]
    tbatch = {k: torch.from_numpy(v).cuda() for k, v in tds.make_batch(
        tmeta, np.arange(tcfg17.batch_size), 0, 0, packed=True).items()}

    def token_ctx(_model):
        toks, _, valid = (torch.from_numpy(x).cuda() for x in
                          tds.window_ref_tokens(tmeta, pad_haps_to=2048))
        wmask = torch.from_numpy(tds.window_mask(tmeta, 0, 0)).cuda()
        return build_token_window_ctx(toks.long(), wmask, valid=valid)

    truns = {}
    for mode in (False, True, "save_most"):
        cfg = dataclasses.replace(tcfg17, model=dataclasses.replace(
            tcfg17.model, remat=mode))
        truns[mode] = _remat_run(
            cfg, tbundle.vocab.size, tbatch, token_ctx, timed=2,
            profile=profile and f"v17_token_rag remat={mode!r}")
        _add(counts, truns[mode]["launches"])
    for mode, r in truns.items():
        same = _same_run(r, truns[False])
        print(f"v17_token_rag remat={mode!r} (batch {tcfg17.batch_size}, "
              f"attention dropout 0.1): loss {r['loss'].item():.6f}; "
              f"bit-identical to remat=False: {same}; micro-step median "
              f"{r['ms']:.1f} ms; peak device memory {r['peak_gb']:.2f} GB "
              f"({r['act_gb']:.2f} GB above the resident state); launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }")
        check(all(same.values()) and r["launches"]["l2_topk_rf"] == 4
              and r["launches"]["attention_f32_bwd"] == 4 * tcfg17.model
              .n_layers, f"v17 remat={mode!r} changed a number or skipped "
              "l2_topk_rf or the float32 attention kernels")
        check(mode is not True or r["peak_gb"] < truns[False]["peak_gb"],
              f"v17 remat={mode!r} did not lower the peak")
    del truns, tbatch
    torch.cuda.empty_cache()

    # (4) the alternative fusions
    _fusions_on_the_card()
    return counts


# The distributed phase.  The machine has one card: NCCL refuses two ranks
# on one device, so NCCL is proven in a one-rank world (bit-identical to
# the run without a mesh, both fits under torch's deterministic
# algorithms: torch's CUDA embedding backward sums a token's rows in an
# order that varies from run to run, so two fits without a mesh differ
# in the token embedding's last bits), and the shard logic runs in gloo
# worlds whose ranks share the card (gloo stages a CUDA tensor through
# host memory for all_gather and point-to-point, parallel/comm.py).
# Tolerances: dp2 x idx2 training against the single-process fit, both
# bf16 on the card with rows batched differently, by tools/mesh_check.py's
# compare_fits (loss, parameters, each micro-step's gradient norm and the
# parameter change), with a control run without the gradient sum that
# must fail it; tp3 serving and dp2 imputation within the serving bands
# (PROB_MEAN_TOL, PROB_MAX_TOL: bf16 roundings; tp3 sums its row-parallel
# partial products in bf16); the sharded genotype index exactly (integer
# distances, ties to the lower id on both sides).
DISPATCH_DIR = "runs/chip_smoke_dispatch"
DISPATCH_K = 4
DISPATCH_KERNELS = {"tpu_default": ("attention", "attention_bwd", "l2_topk",
                                    "residual", "residual_bwd"),
                    "v17_token_rag": ("attention_f32", "attention_f32_bwd",
                                      "l2_topk_rf")}


def _dispatch_trainer(preset: str, ds, vocab: int, k: int, batch: int,
                      out: str, mesh=None, **model_kw):
    """A fresh ``Trainer`` of ``preset`` (seed 0; ``model_kw`` replaces
    model fields) over ``ds``: one epoch at ``batch`` with the preset's
    accumulation and schedule, no validation, ``steps_per_dispatch=k``."""
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = PRESETS[preset]
    if model_kw:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, **model_kw))
    shutil.rmtree(out, ignore_errors=True)
    tcfg = TrainerConfig(
        epochs=1, batch_size=batch, val_batch_size=batch,
        init_lr=cfg.init_lr, max_lr=cfg.max_lr, warmup_steps=cfg.warmup_steps,
        grad_accum_steps=cfg.grad_accum_steps, focal_gamma=cfg.focal_gamma,
        rag_k=cfg.rag_k, ref_pad_haps=2048, output_dir=out, log_freq=1000,
        seed=0, rag_mode=cfg.model.rag_mode, steps_per_dispatch=k,
        record_step_times=True, async_checkpoints=False, keep_checkpoints=1)
    return Trainer(build_model(cfg, vocab, seed=0), ds, tcfg, mesh=mesh)


def _dispatch_fit(trainer) -> dict:
    """One epoch of ``trainer.fit()``: its metrics (not the seconds), its
    parameters, Adam moments and counters on the host, the launches, the
    seconds, peak device memory (allocated and reserved: a graph's
    replays allocate nothing, its pool is reserved) and the runner's
    graphs captured and replays."""
    from rag_snvbert_tpu_torch import ops

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    row = trainer.fit()["history"][0]
    torch.cuda.synchronize()
    opt, runner = trainer.optimizer, trainer.runner
    return {
        "s": time.perf_counter() - t,
        "row": {k: v for k, v in row.items() if "seconds" not in k},
        "params": {k: v.detach().cpu() for k, v in
                   trainer.model.state_dict().items()},
        "moments": [x.detach().cpu() for x in (*opt.mu, *opt.nu,
                                               *(opt.acc or []))],
        "counters": (opt.count, opt.mini_step, trainer.step),
        "launches": ops.launch_counts(),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
        "graphs": 0 if runner is None else runner.graphs.captures,
        "replays": 0 if runner is None else runner.graphs.replays}


def _dispatch_pair(name: str, preset: str, ds, vocab: int, k: int,
                   batch: int, kernels: tuple, mesh=None,
                   **model_kw) -> dict:
    """Under deterministic algorithms, one epoch at K = 1 and one at
    ``k`` from the same seeded weights: parameters, Adam moments,
    counters and every epoch metric held bit for bit, and every kernel
    launched as often as K = 1 launched it (a warm-up's and a capture's
    launches are taken back, a replay adds its graph's), each kernel of
    ``kernels`` at least once.  Returns the K = ``k`` run's launches."""
    runs = {}
    with _deterministic():
        for kk in (1, k):
            trainer = _dispatch_trainer(
                preset, ds, vocab, kk, batch,
                os.path.join(DISPATCH_DIR, f"{name}_k{kk}"), mesh,
                **model_kw)
            runs[kk] = _dispatch_fit(trainer)
            del trainer
    one, many = runs[1], runs[k]
    differ = [n for n, v in one["params"].items()
              if not torch.equal(many["params"][n], v)]
    same = {"params": not differ,
            "moments": all(torch.equal(a, b) for a, b in
                           zip(one["moments"], many["moments"])),
            "metrics": one["row"] == many["row"],
            "counters": one["counters"] == many["counters"]}
    unlaunched = [n for n in kernels if not one["launches"][n]]
    print(f"dispatch {name}: {one['counters'][2]} micro-steps at batch "
          f"{batch}, K = {k}: {many['graphs']} graphs captured, "
          f"{many['replays']} replays; train_loss "
          f"{many['row']['train_loss']!r} (K = 1 {one['row']['train_loss']!r});"
          f" bit for bit against K = 1: {same}"
          + (f" (parameters differ: {differ[:6]})" if differ else "")
          + f"; launches {many['launches']} (K = 1 {one['launches']}); "
          f"fit {one['s']:.2f} s / {many['s']:.2f} s; peak allocated "
          f"{one['peak_gb']:.2f} / {many['peak_gb']:.2f} GB, reserved "
          f"{one['reserved_gb']:.2f} / {many['reserved_gb']:.2f} GB "
          f"(K = 1 / K = {k})")
    if not same["metrics"]:
        print("  metrics K = 1: " + json.dumps(one["row"]))
        print(f"  metrics K = {k}: " + json.dumps(many["row"]))
    check(all(same.values()), f"dispatch {name}: K = {k} is not bit-identical"
          f" to K = 1: {same}")
    check(many["launches"] == one["launches"] and not unlaunched,
          f"dispatch {name}: the kernels were not launched as often as by "
          f"single steps, or {unlaunched} not at all")
    check(many["graphs"] >= 1 and many["replays"] >= 1,
          f"dispatch {name}: no graph was replayed")
    return many["launches"]


def _dispatch_timing(name: str, preset: str, ds, vocab: int, batch: int,
                     profile: bool) -> None:
    """Outside deterministic mode: a K = 1 and a K = DISPATCH_K trainer
    from the same weights, each with one epoch to warm up (the graphs are
    captured there), then one epoch each in turns A B B A, every epoch
    timed on the host clock to a synchronize(); with ``profile`` one chunk
    and as many single micro-steps under torch.profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from rag_snvbert_tpu_torch.train import step
    from rag_snvbert_tpu_torch.train.trainer import _chunk_batches

    arms = {kk: _dispatch_trainer(preset, ds, vocab, kk, batch, os.path.join(
        DISPATCH_DIR, f"{name}_time_k{kk}")) for kk in (1, DISPATCH_K)}
    for t in arms.values():
        t._run_epoch(0, train=True)
    times: dict[int, list[float]] = {1: [], DISPATCH_K: []}
    epoch = 1
    for kk in (1, DISPATCH_K, DISPATCH_K, 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = arms[kk]._run_epoch(epoch, train=True)["n_batches"]
        torch.cuda.synchronize()
        times[kk].append((time.perf_counter() - t) * 1e3 / n)
        epoch += 1
    print(f"dispatch timing {name} (batch {batch}, {n} micro-steps an epoch, "
          f"host clock to a synchronize, turns K=1 K={DISPATCH_K} "
          f"K={DISPATCH_K} K=1): ms a micro-step K = 1 "
          f"{[round(x, 2) for x in times[1]]}, K = {DISPATCH_K} "
          f"{[round(x, 2) for x in times[DISPATCH_K]]}; mean "
          f"{statistics.mean(times[1]):.2f} -> "
          f"{statistics.mean(times[DISPATCH_K]):.2f} ms "
          f"({batch * 1e3 / statistics.mean(times[1]):.1f} -> "
          f"{batch * 1e3 / statistics.mean(times[DISPATCH_K]):.1f} samples/s)"
          f"; {card_line()}")
    if profile:
        t = arms[DISPATCH_K]
        meta, chunk = next(_chunk_batches(t.train_ds.epoch_batches(
            batch, 0, 0, packed=True), DISPATCH_K))
        batches = t._put_batch(chunk)
        ctx = t._window_ctx(t.train_ds, meta, 0, 0)
        for rep in range(2):          # the first may capture a new key
            torch.cuda.synchronize()
            with trace(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                w = time.perf_counter()
                t.runner.run(batches, ctx, t.step)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - w) * 1e3
            t.step += DISPATCH_K
        _print_profile(f"{name}: one chunk of {DISPATCH_K} micro-steps, one "
                       f"replay", prof, wall)
        one = arms[1]
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            w = time.perf_counter()
            for j in range(DISPATCH_K):
                step.train_step(one.model, one.optimizer,
                                {k: v[j] for k, v in batches.items()}, ctx,
                                one.step_cfg, step.step_generator(
                                    0, one.step + j, one.device))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w) * 1e3
        _print_profile(f"{name}: the same {DISPATCH_K} micro-steps one by "
                       f"one", prof, wall)
    del arms


def phase_dispatch(profile: bool = False) -> dict[str, int]:
    """``steps_per_dispatch`` (``train/dispatch.py``): each chunk of
    micro-steps one CUDA graph replay, held bit for bit against single
    steps under deterministic algorithms: V18 ``tpu_default`` (batch 24,
    accumulation 2, 2 windows of 5 batches: chunks of 4 and 1 whose
    accumulation phase moves from window to window) at K = 4, V17
    ``v17_token_rag`` at K = 4 (batch 8: V17 peaks at 51.75 GB at batch
    16), each remat mode, ``int8_matmuls`` and a one-rank NCCL mesh at
    K = 2; a mesh over gloo raises.  Then K = 1 against K = 4 timed in turns.  Returns
    the launches of the K > 1 runs."""
    import tempfile

    import torch.distributed as dist

    from rag_snvbert_tpu_torch.parallel.mesh import (init_distributed,
                                                     make_mesh)

    shutil.rmtree(DISPATCH_DIR, ignore_errors=True)
    total: dict[str, int] = {}
    v18 = DISPATCH_KERNELS["tpu_default"]
    bundle, ds = _train_bundle(120)
    vocab = bundle.vocab.size
    _add(total, _dispatch_pair("V18", "tpu_default", ds, vocab, DISPATCH_K,
                               24, v18))
    for mode in (True, "save_ffn", "attention", "save_most"):
        _add(total, _dispatch_pair(f"V18 remat {mode}", "tpu_default", ds,
                                   vocab, 2, 24, v18, remat=mode))
    _add(total, _dispatch_pair("V18 int8_matmuls", "tpu_default", ds, vocab,
                               2, 24, v18, int8_matmuls=True))
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("nccl", rank=0, world_size=1,
                         init_method=f"file://{tmp}/rendezvous")
        try:
            _add(total, _dispatch_pair("V18 one-rank NCCL mesh",
                                       "tpu_default", ds, vocab, 2, 24, v18,
                                       make_mesh(1, 1, 1)))
        finally:
            dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("gloo", rank=0, world_size=1,
                         init_method=f"file://{tmp}/rendezvous")
        try:
            _dispatch_trainer("tpu_default", ds, vocab, 2, 24,
                              os.path.join(DISPATCH_DIR, "gloo"),
                              make_mesh(1, 1, 1))
            refused = None
        except ValueError as e:
            refused = str(e)
        finally:
            dist.destroy_process_group()
    print(f"dispatch with a mesh over gloo on the card: {refused}")
    check(refused is not None and "gloo" in refused,
          "a gloo mesh at steps_per_dispatch > 1 was not refused")
    _dispatch_timing("V18", "tpu_default", ds, vocab, 24, profile)
    del bundle, ds
    gc.collect()
    torch.cuda.empty_cache()

    bundle, ds = _train_bundle(40)
    vocab = bundle.vocab.size
    _add(total, _dispatch_pair("V17", "v17_token_rag", ds, vocab, DISPATCH_K,
                               8, DISPATCH_KERNELS["v17_token_rag"]))
    _dispatch_timing("V17", "v17_token_rag", ds, vocab, 8, profile)
    gc.collect()
    return total


DIST_DIR = "runs/chip_smoke_dist"


def _dist_train_rank(rank: int, out_dir: str, single: dict) -> dict:
    """One rank of the dp2 x idx2 world: Trainer.fit held to the
    single-process ``single``; one batch's sharded l2_topk ids against the
    single-process kernel over the whole context (after the launch counts
    are read); then the control, a fit without the gradient sum."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.index.sharded import sharded_search
    from rag_snvbert_tpu_torch.ops.l2_topk import l2_topk
    from rag_snvbert_tpu_torch.parallel.mesh import make_mesh
    from rag_snvbert_tpu_torch.tools.mesh_check import (
        allreduce_ms, compare_fits, fit, make_trainer)
    from rag_snvbert_tpu_torch.train.retrieval import encode_window_refs
    from rag_snvbert_tpu_torch.train.step import expand_packed

    mesh = make_mesh(2, 2, 1)
    trainer, ds = make_trainer(mesh, out_dir)
    ops.reset_launches()
    got = fit(trainer)
    out = {"launches": ops.launch_counts(), "shard_ctx": trainer.shard_ctx,
           "loss": got["loss"], "wall_s": got["wall_s"],
           "step_ms": got["step_ms"], "cmp": compare_fits(got, single),
           "allreduce_ms": allreduce_ms(trainer)}
    del got
    # ids: this data rank's rows of window 0's first batch, kernel per
    # shard + merge, against the kernel over the whole 2048-row context
    meta = ds.windows[0]
    d = mesh.get_local_rank("data")
    batch = expand_packed(trainer._put_batch(ds.make_batch(
        meta, np.arange(12 * d, 12 * d + 12), 0, 0, packed=True)))
    model = trainer.model.eval()
    with torch.no_grad():
        ctx = trainer._window_ctx(ds, meta, 0, 0)
        toks = torch.cat([batch["hap_1"], batch["hap_2"]])
        q = model.embed(toks, torch.cat([batch["af"], batch["af"]]))
        qf = q.to(torch.bfloat16).reshape(q.shape[0], -1)
        rf = ctx.ref_emb_search.reshape(ctx.rows_per_shard, -1)
        _, ids = sharded_search(
            lambda qq, k: l2_topk(qq, rf, ctx.ref_norms, k), qf, 1,
            ctx.rows_per_shard, ctx.shard, ctx.group)
        toks_all, af, valid = (torch.from_numpy(x).cuda() for x in
                               ds.window_ref_tokens(meta, pad_haps_to=2048))
        full = encode_window_refs(
            model.embed, toks_all.long(), af,
            torch.from_numpy(ds.window_mask(meta, 0, 0)).cuda(), valid=valid)
        _, one = l2_topk(qf, full.ref_emb_search.reshape(2048, -1),
                         full.ref_norms, 1)
        out["ids"] = _exact_nearest(q, full, ids[:, 0].int(),
                                    one[:, 0].int())
    del trainer, model, ctx, full
    torch.cuda.empty_cache()
    control = make_trainer(mesh, os.path.join(out_dir, "control"))[0]
    out["control"] = compare_fits(fit(control, sum_gradients=False), single)
    return out


def _dist_serve_rank(rank: int, targets: list) -> dict:
    """One rank of the tp3 world: the serving bundle through
    ImputationService (rank 0 the front end, the others following)."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.infer.serve import ImputationService
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 1, 3)
    bundle = make_bundle(n_train_samples=64, n_ref_samples=1004,
                         n_sites=3 * 1020, n_windows=3, seed=17)
    cfg = PRESETS["tpu_default"]
    svc = ImputationService.create(build_model(cfg, bundle.vocab.size,
                                               seed=0),
                                   bundle.ref, bundle.freq, batch_size=32,
                                   mesh=mesh)
    heads = svc.imputer.model.bert.encoder.block_0.attention.local_heads
    ops.reset_launches()
    out = {"heads": heads, "sec": []}
    if rank == 0:
        out["results"] = []
        for target in targets:
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = svc.handle_target(target)
            torch.cuda.synchronize()
            out["sec"].append(time.perf_counter() - t)
            out["results"].append({f: getattr(res, f) for f in
                                   ("hap1_prob", "hap2_prob", "gt_prob")})
        svc.release()
    else:
        out["followed"] = svc.follow()
    out["launches"] = ops.launch_counts()
    return out


TP2_TRAIN_LAYERS = 4      # the tp2 world's fits: tpu_default cut in depth


def _tp2_configs():
    """``tpu_default`` and its ``int8_matmuls=True`` twin: to serve, and
    cut to ``TP2_TRAIN_LAYERS`` layers to train."""
    from rag_snvbert_tpu_torch.config import PRESETS

    cfg = PRESETS["tpu_default"]
    int8 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, int8_matmuls=True))
    return {name: (c, dataclasses.replace(c, model=dataclasses.replace(
        c.model, n_layers=TP2_TRAIN_LAYERS)))
        for name, c in (("bf16", cfg), ("int8", int8))}


def _dist_tp2_rank(rank: int, target, singles: dict, out_dir: str) -> dict:
    """One rank of the tp2 world, whose 192 columns a rank split one of
    ``tpu_default``'s three heads of 128 (rank 0 runs heads 0-1, rank 1
    heads 1-2): the serving bundle's first target through
    ImputationService (rank 0 the front end), bf16 and ``int8_matmuls``;
    then Trainer.fit of each, cut in depth, held to its single-process
    fit in ``singles``, and the bf16 fit with the split head's gradient
    sum skipped (the control).  Launch counts per part."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import build_model
    from rag_snvbert_tpu_torch.infer.serve import ImputationService
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.parallel.mesh import make_mesh
    from rag_snvbert_tpu_torch.tools.mesh_check import (
        compare_fits, fit, make_trainer, split_head_control)

    mesh = make_mesh(1, 1, 2)
    bundle = make_bundle(n_train_samples=64, n_ref_samples=1004,
                         n_sites=3 * 1020, n_windows=3, seed=17)
    out: dict = {}
    for name, (serve_cfg, train_cfg) in _tp2_configs().items():
        t = time.perf_counter()
        svc = ImputationService.create(build_model(
            serve_cfg, bundle.vocab.size, seed=0), bundle.ref, bundle.freq,
            batch_size=32, mesh=mesh)
        att = svc.imputer.model.bert.encoder.block_0.attention
        part = {"heads": (att.local_heads, att.head_split)}
        ops.reset_launches()
        if rank == 0:
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = svc.handle_target(target)
            torch.cuda.synchronize()
            part["sec"] = time.perf_counter() - t
            part["result"] = {f: getattr(res, f) for f in
                              ("hap1_prob", "hap2_prob", "gt_prob")}
            svc.release()
        else:
            part["followed"] = svc.follow()
        part["launches"] = ops.launch_counts()
        part["wall_s"] = time.perf_counter() - t
        out["serve", name] = part
        del svc, att
        torch.cuda.empty_cache()
        runs = [(name, False)] + ([("control", True)] if name == "bf16"
                                  else [])
        for label, control in runs:
            t = time.perf_counter()
            trainer = make_trainer(mesh, os.path.join(out_dir, label),
                                   train_cfg)[0]
            ops.reset_launches()
            with split_head_control() if control else \
                    contextlib.nullcontext():
                got = fit(trainer)
            out["fit", label] = {
                "launches": ops.launch_counts(), "loss": got["loss"],
                "step_ms": got["step_ms"], "wall_s": time.perf_counter() - t,
                "cmp": compare_fits(got, singles[name])}
            del trainer, got
            torch.cuda.empty_cache()
    out["launches"] = {}
    for part in list(out.values()):
        _add(out["launches"], part.get("launches", {}))
    return out


def _dist_index_rank(rank: int, target) -> dict:
    """One rank of the two-rank world: dp2 imputation of the serving
    bundle, then the genotype index sharded over both ranks in four
    storages, each searched with both merges."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.index.sharded import ShardedFlatL2Index
    from rag_snvbert_tpu_torch.infer.imputer import Imputer
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.parallel.mesh import make_mesh
    from rag_snvbert_tpu_torch.tools.mesh_check import STORAGES, index_bits

    out = {}
    bundle = make_bundle(n_train_samples=64, n_ref_samples=1004,
                         n_sites=3 * 1020, n_windows=3, seed=17)
    imp = Imputer(build_model(PRESETS["tpu_default"], bundle.vocab.size,
                              seed=0), bundle.ref, bundle.freq,
                  batch_size=32, mesh=make_mesh(2, 1, 1))
    ops.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = imp.impute(target)
    torch.cuda.synchronize()
    out["infer_sec"] = time.perf_counter() - t
    out["infer"] = {f: getattr(res, f) for f in ("hap1_prob", "hap2_prob",
                                                 "gt_prob")}
    del imp
    torch.cuda.empty_cache()
    mesh = make_mesh(1, 2, 1)
    b, n, d = FLOAT_INDEX
    bits, q = index_bits(n, d, b, "cuda")
    out["search"] = {}
    for name, kw, _ in STORAGES:
        idx = ShardedFlatL2Index.build(mesh, bits, **kw)
        for merge in ("all_gather", "ring"):
            idx.search(q, 10, merge=merge)        # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            v, i = idx.search(q, 10, merge=merge)
            torch.cuda.synchronize()
            out["search"][name, merge] = ((time.perf_counter() - t) * 1e3,
                                          v.cpu(), i.cpu())
        del idx
        torch.cuda.empty_cache()
    out["launches"] = ops.launch_counts()
    return out


def _spawn(fn, world: int, args: tuple, what: str) -> list:
    from rag_snvbert_tpu_torch.parallel.launch import spawn

    t = time.perf_counter()
    try:
        runs = spawn(fn, world, args, backend="gloo")
    except Exception as e:       # a rank failed a check or raised
        fail(f"{what}: a rank failed ({type(e).__name__}: {e})")
    print(f"{what}: {time.perf_counter() - t:.1f} s wall ({world} gloo "
          f"ranks sharing the card, start-up included); launches per rank "
          f"{[r['launches'] for r in runs]}")
    return runs


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms (and cuDNN's) for the block: the
    CUDA embedding backward then sums in a fixed order.  Their cuBLAS
    calls need CUBLAS_WORKSPACE_CONFIG, which main() sets."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _add_tp2(total: dict, target, ref, ref_sec: float, band) -> dict:
    """The tp2 world (``_dist_tp2_rank``) against single-process runs made
    here: the int8 service's warm request and the two fits cut in depth
    (the bf16 service's, ``ref``, comes from the tp3 part).  Adds the
    ranks' launches to ``total`` and returns it."""
    from rag_snvbert_tpu_torch.config import build_model
    from rag_snvbert_tpu_torch.infer.serve import ImputationService
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.tools.mesh_check import (
        TP_DELTA_TOL, TP_NORM_TOL, fit, fit_failures, make_trainer)

    t0 = time.perf_counter()
    cfgs = _tp2_configs()
    bundle = make_bundle(n_train_samples=64, n_ref_samples=1004,
                         n_sites=3 * 1020, n_windows=3, seed=17)
    svc = ImputationService.create(build_model(
        cfgs["int8"][0], bundle.vocab.size, seed=0), bundle.ref,
        bundle.freq, batch_size=32)
    svc.handle_target(target)          # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    refs = {"bf16": (ref, ref_sec), "int8": (svc.handle_target(target),
                                              None)}
    torch.cuda.synchronize()
    refs["int8"] = (refs["int8"][0], time.perf_counter() - t)
    del svc
    torch.cuda.empty_cache()
    singles = {name: fit(make_trainer(None, os.path.join(
        DIST_DIR, f"tp2_single_{name}"), train_cfg)[0])
        for name, (_, train_cfg) in cfgs.items()}
    print(f"tp2 single-process references: {time.perf_counter() - t0:.1f} "
          "s")
    runs = _spawn(_dist_tp2_rank, 2, (target, singles,
                                      os.path.join(DIST_DIR, "tp2")),
                  "tp2 serving and training (split heads)")
    serve_layers = cfgs["bf16"][0].model.n_layers
    batches = 3 * 2
    micro = 4
    for rank, r in enumerate(runs):
        _add(total, r["launches"])
        want_split = (0, 0, 192) if rank == 0 else (1, 64, 192)
        for name in cfgs:
            part = r["serve", name]
            want = {"attention": serve_layers * batches, "attention_bwd": 0,
                    "attention_f32": 0, "attention_f32_bwd": 0,
                    **block_want(part["launches"], True), "l2_topk": batches,
                    "l2_topk_rf": 0, "l2_topk_float": 0}
            check(part["heads"] == (2, want_split)
                  and part["launches"] == want,
                  f"tp2 {name} serving rank {rank}: heads "
                  f"{part['heads']}, launches {part['launches']}, want "
                  f"(2, {want_split}) and {want}")
            check(part.get("followed", 1) == 1,
                  f"tp2 {name} serving rank {rank} did not follow the "
                  f"request")
        for label in ("bf16", "control", "int8"):
            part = r["fit", label]
            want = {"attention": TP2_TRAIN_LAYERS * micro,
                    "attention_bwd": TP2_TRAIN_LAYERS * micro,
                    "attention_f32": 0, "attention_f32_bwd": 0,
                    **block_want(part["launches"], True, True),
                    "l2_topk": micro, "l2_topk_rf": 0, "l2_topk_float": 0}
            check(part["launches"] == want,
                  f"tp2 {label} fit rank {rank} launches "
                  f"{part['launches']}, want {want}")
            bad = fit_failures(part["cmp"], model_axis=True)
            if label == "control":
                check(bool(bad), f"the control without the split head's "
                      f"gradient sum passes the tp2 checks: {part['cmp']}")
            else:
                check(not bad, f"tp2 {label} fit rank {rank}: {bad}")
    med = statistics.median
    print("tp2 world parts, wall s on rank 0 (set-up included): "
          + ", ".join(f"{' '.join(k)} {v['wall_s']:.1f}"
                      for k, v in runs[0].items() if k != "launches"))
    for name in cfgs:
        mean_d, max_d = band(runs[0]["serve", name]["result"],
                             refs[name][0])
        print(f"tp2 {name} serving (tpu_default, 192 columns a rank: "
              f"heads 0-1 and 1-2, the attention kernel on 2 whole heads a "
              f"rank): request {runs[0]['serve', name]['sec']:.3f} s "
              f"(first, gloo staging the gathers and sums through the "
              f"host) vs {refs[name][1]:.3f} s single-process (warm); "
              f"mean/max |dp| over imputed genotypes {mean_d:.3e}/"
              f"{max_d:.3e} (tol {PROB_MEAN_TOL}/{PROB_MAX_TOL}); "
              f"{card_line()}")
        check(mean_d <= PROB_MEAN_TOL and max_d <= PROB_MAX_TOL,
              f"tp2 {name} serving left the band of the single-process "
              "service")
    for label, name in (("bf16", "bf16"), ("control", "bf16"),
                        ("int8", "int8")):
        c = [r["fit", label]["cmp"] for r in runs]
        print(f"tp2 {label} fit ({TP2_TRAIN_LAYERS}-layer tpu_default"
              f"{', int8_matmuls' if name == 'int8' else ''}, 4 micro-steps"
              f"{', split head gradient sum skipped: must fail' if label == 'control' else ''}): "
              f"worst rank loss rel {max(x['loss_rel'] for x in c):.2e}, "
              f"params rel {max(x['param_rel'] for x in c):.2e}, gradient "
              f"norm rel {max(x['norm_rel'] for x in c):.2e} (tol "
              f"{TP_NORM_TOL}), parameter change L2 rel "
              f"{max(x['delta_rel'] for x in c):.2e} (tol {TP_DELTA_TOL}); "
              f"micro-step median "
              f"{[round(med(r['fit', label]['step_ms']), 1) for r in runs]}"
              f" ms per rank (2 ranks time-sharing the card) vs "
              f"{med(singles[name]['step_ms']):.1f} ms single-process; "
              f"{card_line()}")
    return total


def phase_distributed(profile: bool = False) -> dict[str, int]:
    """The scale-out path (parallel/, index/sharded.py,
    train/sharded_retrieval.py): a one-rank NCCL world against the runs
    without a mesh, then gloo worlds of ranks sharing the card: dp2 x idx2
    training, tp3 serving, tp2 serving and training with split heads
    (bf16 and ``int8_matmuls``), dp2 imputation and the two-shard genotype
    index.  Returns the launches of every rank's mesh run summed (the
    single-process references are not counted)."""
    import tempfile

    import torch.distributed as dist

    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import PRESETS, build_model
    from rag_snvbert_tpu_torch.index import FlatL2Index
    from rag_snvbert_tpu_torch.index.sharded import ShardedFlatL2Index
    from rag_snvbert_tpu_torch.infer.serve import ImputationService
    from rag_snvbert_tpu_torch.io.synthetic import make_bundle
    from rag_snvbert_tpu_torch.parallel.mesh import (init_distributed,
                                                     make_mesh)
    from rag_snvbert_tpu_torch.tools.mesh_check import (
        DELTA_TOL, NORM_TOL, STORAGES, fit, fit_failures, index_bits,
        make_trainer)

    m = PRESETS["tpu_default"].model
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    total: dict[str, int] = {}

    # 1. one-rank NCCL world: the mesh run equals the run without one
    t0 = time.perf_counter()
    trainer = make_trainer(None, os.path.join(DIST_DIR, "single"))[0]
    emb = trainer.model.bert.embedding.Embed_0
    seen: dict = {}

    def grab(mod, inp, out):            # the fit's first lookup with grad
        if out.requires_grad and not seen:
            seen["ids"] = inp[0].detach().clone()
            out.register_hook(lambda g: seen.setdefault(
                "grad", g.detach().float().clone()))

    hook = emb.register_forward_hook(grab)
    with _deterministic():
        single = fit(trainer)
    hook.remove()
    # why: torch's embedding backward on that lookup, rerun 20 times
    same = {}
    for det in (False, True):
        torch.use_deterministic_algorithms(det)
        outs = [torch.ops.aten.embedding_dense_backward(
            seen["grad"], seen["ids"], emb.num_embeddings, -1, False)
            for _ in range(20)]
        same[det] = sum(torch.equal(o, outs[0]) for o in outs)
    torch.use_deterministic_algorithms(False)
    print(f"torch's CUDA embedding backward on a micro-step's lookup "
          f"({list(seen['ids'].shape)} ids, {emb.num_embeddings} rows): 20 "
          f"reruns equal to the first in {same[False]} of 20, under "
          f"deterministic algorithms in {same[True]} of 20")
    check(same[True] == 20, "the embedding backward is not reproducible "
          "under deterministic algorithms")
    del trainer, emb, seen
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("nccl", rank=0, world_size=1,
                         init_method=f"file://{tmp}/rendezvous")
        try:
            mesh = make_mesh(1, 1, 1)
            ops.reset_launches()
            with _deterministic():
                nccl = fit(make_trainer(mesh, os.path.join(DIST_DIR,
                                                           "nccl"))[0])
            bits, q = index_bits(131072, 2040, 1024, "cuda")
            sidx = ShardedFlatL2Index.build(mesh, bits,
                                            dtype=torch.bfloat16)
            got = sidx.search(q, 10)
            _add(total, ops.launch_counts())
            nccl_counts = ops.launch_counts()
            want = FlatL2Index.build(bits, dtype=torch.bfloat16).search(
                q, 10, use_pallas=True)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    differ = [k for k, v in single["params"].items()
              if not torch.equal(nccl["params"][k], v)]
    same_fit = nccl["loss"] == single["loss"] and not differ
    # the summed gradients are views into one flat buffer, whose other
    # alignment may change a norm's reduction order: ulps, not bits
    norm_rel = max(abs(a - b) / b for a, b in zip(nccl["grad_norms"],
                                                  single["grad_norms"]))
    same_search = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1])
    print(f"one-rank {backend} world: Trainer(mesh=1x1x1) 4 micro-steps at "
          f"tpu_default loss {nccl['loss']:.6f} vs {single['loss']:.6f} "
          f"without a mesh, loss and parameters bit-identical {same_fit}, "
          f"micro-step gradient norms within {norm_rel:.1e}; "
          f"ShardedFlatL2Index "
          f"(bf16, [1024] x [131072, 2040]) bit-identical to FlatL2Index "
          f"{same_search}; launches {nccl_counts}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(backend == "nccl" and same_fit and same_search
          and len(nccl["grad_norms"]) == len(single["grad_norms"]) == 4
          and norm_rel <= 1e-6,
          f"the one-rank NCCL world differs from the run without a mesh: "
          f"backend {backend}, loss {nccl['loss']!r} vs {single['loss']!r}, "
          f"{len(differ)} parameter tensors differ {differ[:4]}, gradient "
          f"norms {nccl['grad_norms']} vs {single['grad_norms']}, search "
          f"bit-identical {same_search}")
    del bits, q, sidx, got, want
    torch.cuda.empty_cache()

    # 2a. dp2 x idx2 training, 4 gloo ranks on the card
    runs = _spawn(_dist_train_rank, 4,
                  (os.path.join(DIST_DIR, "dp2xidx2"), single),
                  "dp2 x idx2 training (and its control)")
    micro = 4
    per_rank = {"attention": m.n_layers * micro,
                "attention_bwd": m.n_layers * micro, "attention_f32": 0,
                "attention_f32_bwd": 0, "l2_topk": micro,
                "l2_topk_rf": 0, "l2_topk_float": 0}
    for r in runs:
        _add(total, r["launches"])
        per_rank.update(block_want(r["launches"], True, True))
        check(r["shard_ctx"] and r["launches"] == per_rank,
              f"dp2 x idx2 rank launches {r['launches']}, want {per_rank}")
        check(not fit_failures(r["cmp"]),
              f"dp2 x idx2 fit: {fit_failures(r['cmp'])}")
        check(r["control"]["norm_rel"] > NORM_TOL
              and r["control"]["delta_rel"] > DELTA_TOL,
              f"the control without the gradient sum passes the dp2 x idx2 "
              f"checks: {r['control']}")
        ids = r["ids"]
        check(ids["kernel_excess"] <= INTEROP_TIE_REL,
              f"sharded l2_topk picks off the nearest: {ids}")
    st = {k: [r["ids"][k] for r in runs] for k in ("differ", "queries")}

    def worst(key: str, what: str = "cmp") -> str:
        return f"{max(r[what][key] for r in runs):.2e}"

    med = statistics.median
    print(f"dp2 x idx2: loss {[round(r['loss'], 6) for r in runs]} vs "
          f"{single['loss']:.6f} single-process; worst rank: loss rel "
          f"{worst('loss_rel')}, params rel {worst('param_rel')}, micro-step "
          f"gradient norm rel {worst('norm_rel')} (tol {NORM_TOL}; rank 0 "
          f"by micro-step {[float(f'{x:.2e}') for x in runs[0]['cmp']['norm_rels']]}), "
          f"parameter change L2 rel {worst('delta_rel')} (tol {DELTA_TOL}); "
          f"control without the gradient sum: gradient norm rel >= "
          f"{min(r['control']['norm_rel'] for r in runs):.2e}, parameter "
          f"change L2 rel >= {min(r['control']['delta_rel'] for r in runs):.2e}"
          f" (both must fail); micro-step median "
          f"{[round(med(r['step_ms']), 1) for r in runs]}"
          f" ms per rank (4 ranks time-sharing one card) vs "
          f"{med(single['step_ms']):.1f} ms single-process (deterministic "
          f"algorithms), gradient "
          f"all-reduce {[round(r['allreduce_ms'], 1) for r in runs]} ms a "
          f"micro-step (gloo, float32); fit "
          f"{[round(r['wall_s'], 2) for r in runs]} s vs "
          f"{single['wall_s']:.2f} s; sharded l2_topk ids (1,024-row "
          f"shards, merged) differ from the single-process kernel's in "
          f"{st['differ']} of {st['queries']} queries per rank, every pick "
          f"within {max(r['ids']['kernel_excess'] for r in runs):.2e} of "
          f"the nearest (tol {INTEROP_TIE_REL:.0e}), exact ties "
          f"{[r['ids']['exact_ties'] for r in runs]}")
    del runs, single
    # 2b. tp3 serving of the serving bundle: the single-process service first
    bundle = make_bundle(n_train_samples=64, n_ref_samples=1004,
                         n_sites=3 * 1020, n_windows=3, seed=17)
    targets = []
    for seed in (1, 2):
        keep = np.random.default_rng(seed).random(bundle.train.n_variants) \
            >= 0.5
        targets.append(_drop(bundle.train, keep))
    svc = ImputationService.create(build_model(PRESETS["tpu_default"],
                                               bundle.vocab.size, seed=0),
                                   bundle.ref, bundle.freq, batch_size=32)
    refs, ref_sec = [], []
    for target in targets:
        svc.handle_target(target)      # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        refs.append(svc.handle_target(target))
        torch.cuda.synchronize()
        ref_sec.append(time.perf_counter() - t)
    del svc
    torch.cuda.empty_cache()

    def band(got: dict, want) -> tuple[float, float]:
        miss = want.imputed_flag
        d = [np.abs(got[f][miss] - getattr(want, f)[miss])
             for f in ("hap1_prob", "hap2_prob", "gt_prob")]
        return max(float(x.mean()) for x in d), max(float(x.max())
                                                    for x in d)

    runs = _spawn(_dist_serve_rank, 3, (targets,), "tp3 serving")
    batches = 3 * 2
    per_rank = {"attention": m.n_layers * batches * 2, "attention_bwd": 0,
                "attention_f32": 0, "attention_f32_bwd": 0,
                "l2_topk": batches * 2, "l2_topk_rf": 0, "l2_topk_float": 0}
    for r in runs:
        _add(total, r["launches"])
        per_rank.update(block_want(r["launches"], True))
        check(r["heads"] == 1 and r["launches"] == per_rank,
              f"tp3 rank: heads {r['heads']}, launches {r['launches']}")
    check(all(r.get("followed", 2) == 2 for r in runs),
          "a tp3 rank did not follow both requests")
    bands = [band(g, w) for g, w in zip(runs[0]["results"], refs)]
    print(f"tp3 serving (one head of 128 a rank): requests "
          f"{[round(x, 3) for x in runs[0]['sec']]} s vs "
          f"{[round(x, 3) for x in ref_sec]} s single-process (warm); "
          f"mean/max |dp| over imputed genotypes {bands} (tol "
          f"{PROB_MEAN_TOL}/{PROB_MAX_TOL})")
    check(all(a <= PROB_MEAN_TOL and b <= PROB_MAX_TOL for a, b in bands),
          "tp3 serving left the bf16 band of the single-process service")
    del runs
    total = _add_tp2(total, targets[0], refs[0], ref_sec[0], band)

    # 2c + 3. dp2 imputation, then the genotype index over two shards
    b, n, d = FLOAT_INDEX
    bits, q = index_bits(n, d, b, "cuda")
    single_idx = {}
    for name, kw, _ in STORAGES:
        idx = FlatL2Index.build(bits, **kw)
        single_idx[name] = (time_ms(lambda: idx.search(q, 10,
                                                       use_pallas=True), 3),
                            *(x.cpu() for x in idx.search(q, 10,
                                                          use_pallas=True)))
        del idx
        torch.cuda.empty_cache()
    del bits, q
    torch.cuda.empty_cache()
    runs = _spawn(_dist_index_rank, 2, (targets[0],),
                  "dp2 imputation + 2-shard genotype index")
    # each storage searched with both merges, each twice (warm, timed)
    per_rank = {"attention": m.n_layers * batches, "attention_bwd": 0,
                "attention_f32": 0, "attention_f32_bwd": 0,
                "l2_topk": batches, "l2_topk_rf": 2 * 2 * 2,
                "l2_topk_float": 2 * 2 * 2}
    for r in runs:
        _add(total, r["launches"])
        per_rank.update(block_want(r["launches"], True))
        check(r["launches"] == per_rank,
              f"dp2/index rank launches {r['launches']}, want {per_rank}")
    mean_d, max_d = band(runs[0]["infer"], refs[0])
    exact = all(np.array_equal(runs[0]["infer"][f], getattr(refs[0], f))
                for f in ("hap1_prob", "hap2_prob", "gt_prob"))
    print(f"dp2 imputation: {[round(r['infer_sec'], 3) for r in runs]} s "
          f"vs {ref_sec[0]:.3f} s single-process; bit-identical {exact}, "
          f"mean/max |dp| {mean_d:.3e}/{max_d:.3e} (tol "
          f"{PROB_MEAN_TOL}/{PROB_MAX_TOL})")
    check(mean_d <= PROB_MEAN_TOL and max_d <= PROB_MAX_TOL,
          "dp2 imputation differs from the single-process output")
    for name, _, kernel in STORAGES:
        one_ms, sv, si = single_idx[name]
        line = []
        for merge in ("all_gather", "ring"):
            for r in runs:
                ms, v, i = r["search"][name, merge]
                check(torch.equal(v, sv) and torch.equal(i, si),
                      f"sharded {name} index ({merge}) differs from "
                      "FlatL2Index")
            line.append(f"{merge} {[round(r['search'][name, merge][0], 2) for r in runs]} ms")
        print(f"genotype index {name} ({kernel} per 332,324-row shard), "
              f"[1024] x [664,648, 2040] k 10: ids and distances equal to "
              f"the single-process search (ties to the lower id on both); "
              f"sharded search per rank (host clock, two ranks time-sharing "
              f"the card, merge included) {'; '.join(line)}; single-process "
              f"{one_ms:.2f} ms (CUDA events)")
    print(f"distributed launches, every rank's mesh runs summed: {total}")
    return total


QUALITY_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "assets", "quality_ckpt.npz")
# tests/make_quality_ckpt.py's bundle and model (64d, 2 layers, 4 heads,
# float32, post-LN) and tests/test_quality_regression.py's arguments.
QUALITY_BUNDLE = dict(n_train_samples=24, n_ref_samples=48, n_sites=240,
                      n_windows=2, n_founders=48, mean_gap_bp=400, seed=7)
QUALITY_SEQ = 128


def phase_quality_ckpt(profile: bool = False) -> dict[str, int]:
    """The stored trained checkpoint served on the card: imputation of the
    calibrated panel's held-back sites through l2_topk, every search's ids
    held against the plain search's (exact and sub-ulp near-ties excepted,
    INTEROP_TIE_REL in float64), and the quality gates of
    tests/test_quality_regression.py."""
    from rag_snvbert_tpu_torch import ops
    from rag_snvbert_tpu_torch.config import (ModelConfig, RunConfig,
                                              build_model)
    from rag_snvbert_tpu_torch.infer.imputer import Imputer
    from rag_snvbert_tpu_torch.interop import (load_flax_params,
                                               params_from_keystr_npz)
    from rag_snvbert_tpu_torch.io.freq import AF
    from rag_snvbert_tpu_torch.io.synthetic import make_calibrated_bundle
    from rag_snvbert_tpu_torch.train import retrieval

    b = make_calibrated_bundle(**QUALITY_BUNDLE)
    model = build_model(RunConfig(model=ModelConfig(
        dims=64, n_layers=2, attn_heads=4, seq_len=QUALITY_SEQ)),
        b.vocab.size)
    load_flax_params(model, params_from_keystr_npz(QUALITY_CKPT))
    keep = np.random.default_rng(123).random(b.train.n_variants) > 0.4
    real_search, searches = retrieval.search, []

    def held(q, ctx, k, use_kernel=True):
        ids = real_search(q, ctx, k, use_kernel)
        plain = real_search(q, ctx, k, False)
        searches.append(_exact_nearest(q, ctx, ids[:, 0], plain[:, 0]))
        return ids

    retrieval.search = held
    ops.reset_launches()
    try:
        imp = Imputer(model, b.ref, b.freq, window_len=QUALITY_SEQ - 8,
                      seq_len=QUALITY_SEQ, ref_pad_haps=96, batch_size=16)
        imp.use_graphs = False        # the search check sees every batch
        res = imp.impute(_drop(b.train, keep))
    finally:
        retrieval.search = real_search
    counts = ops.launch_counts()
    miss = ~keep
    truth = np.stack([b.train.gt[miss, :, 0], b.train.gt[miss, :, 1]])
    calls = np.stack([res.hap1_prob[miss] >= 0.5,
                      res.hap2_prob[miss] >= 0.5]).astype(np.int8)
    acc = float((calls == truth).mean())
    af = b.freq.lookup(AF, b.freq.global_idx, b.train.pos[miss])
    prior = (af >= 0.5).astype(np.int8)[None, :, None]
    prior_acc = float((np.broadcast_to(prior, truth.shape) == truth).mean())
    rare = np.minimum(af, 1 - af) < 0.05

    def f1(c, t):
        tp = int(((c == 1) & (t == 1)).sum())
        fp, fn = int(((c == 1) & (t == 0)).sum()), int(((c == 0)
                                                        & (t == 1)).sum())
        p, r = tp / max(tp + fp, 1), tp / max(tp + fn, 1)
        return 2 * p * r / max(p + r, 1e-9)

    rare_f1, common_f1 = (f1(calls[:, s], truth[:, s]) for s in (rare,
                                                                 ~rare))
    st = {key: [s[key] for s in searches] for key in searches[0]}
    want = {"attention": 0, "attention_bwd": 0, "attention_f32": 0,
            "attention_f32_bwd": 0, "layer_norm": 0,
            "layer_norm_bwd": 0,
            "residual": 0, "residual_bwd": 0, "l2_topk": len(searches), "l2_topk_rf": 0,
            "l2_topk_float": 0}
    print(f"stored trained checkpoint on the card: accuracy {acc:.4f} "
          f"(prior {prior_acc:.4f}), rare F1 {rare_f1:.4f}, common F1 "
          f"{common_f1:.4f}; {len(searches)} l2_topk searches of "
          f"[{st['queries'][0]}] x [{st['rows'][0]}] rows: kernel ids differ "
          f"from the plain search's in {sum(st['differ'])} of "
          f"{sum(st['queries'])} queries, largest nearest-to-second gap "
          f"where they differ {max(st['differ_gap']):.3e}; kernel pick above "
          f"the nearest by at most {max(st['kernel_excess']):.3e} (tol "
          f"{INTEROP_TIE_REL:.0e}); exact ties {sum(st['exact_ties'])}, "
          f"near ties {sum(st['near_ties'])}; launches {counts}")
    check(counts == want, "the checkpoint was not served through l2_topk")
    check(max(st["kernel_excess"]) <= INTEROP_TIE_REL
          and max(st["differ_gap"]) <= INTEROP_TIE_REL,
          "l2_topk picks a row that is not the nearest on trained weights")
    check(acc >= 0.95 and acc >= prior_acc + 0.10 and rare_f1 >= 0.70
          and common_f1 >= 0.93, "the stored checkpoint failed its gates")
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

    # a 32 MiB cuBLAS workspace (the size PyTorch takes on Hopper), named
    # so that phase_distributed may turn on deterministic algorithms, whose
    # cuBLAS calls require it; read once, at the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    kernels.extend(phase_layer_norm(gen))
    torch.cuda.empty_cache()
    kernels.extend(phase_residual(gen))
    torch.cuda.empty_cache()
    kernels.extend(phase_attention_f32(gen))
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
    probe_entries, probe_counts = phase_probe_mxu(gen)
    kernels.extend(probe_entries)
    print(f"probe_mxu phase {time.perf_counter() - t:.1f} s")
    paths = {"probe_mxu": probe_counts}
    for name, phase in (("serving", phase_serving),
                        ("training", phase_training),
                        ("token_serving", phase_token_serving),
                        ("token_training", phase_token_training),
                        ("remat", phase_remat),
                        ("dispatch", phase_dispatch),
                        ("index", lambda _profile: phase_index(gen)),
                        ("int8", phase_int8),
                        ("cli", phase_cli),
                        ("interop", phase_interop),
                        ("convergence", phase_convergence),
                        ("ab_compat", phase_ab_compat),
                        ("sweep_topk", phase_sweep_topk),
                        ("quality_ckpt", phase_quality_ckpt),
                        ("distributed", phase_distributed)):
        torch.cuda.empty_cache()
        t = time.perf_counter()
        paths[name] = phase(profile)
        print(f"{name} phase {time.perf_counter() - t:.1f} s")
    for kern in kernels:
        # the model and index paths count the five model kernels; only the
        # probe tools launch int8_probe and its int4 pack
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
