#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``rag_snvbert_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py              # what the checks need
    python3 chip_smoke.py --profile    # plus one request under torch.profiler

It builds the CUDA kernels from ``rag_snvbert_tpu_torch/csrc`` (one nvcc
per source, started together), holds each kernel against its plain
PyTorch version at the serving shapes, then serves two imputation requests
through ``ImputationService`` at the full ``tpu_default`` width (384d, 12
layers, 3 heads of 128, L = 1030, a 2048-row window context, batch 32)
with seeded random weights, and checks the answers.  It prints one JSON
line of per-kernel numbers, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that line; so does a machine without CUDA or a directory without the
package.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call is
# the larger of its bytes over the memory rate and its FLOPs over the bf16
# tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

ATTN_SHAPE = (64, 3, 1030, 128)        # [2B, H, L, hd] at batch 32
L2_B, L2_N, L2_D = 64, 2048, 1030 * 384
L2_PAD_ROWS = 40
# Attention: the kernel rounds P to bf16 for the P.V product and writes O
# in bf16 (2^-8 relative); |O| stays below ~4 for unit-normal q, k, v.
ATTN_TOL = 2 ** -6
# L2: |q|^2 - 2 q.r + |r|^2 cancels terms of size |q|^2 + |r|^2 (~1e6 here),
# each a float32 sum of 395,520 products taken in another order on each
# side: errors are measured relative to that scale, eps * sqrt(d) ~ 4e-5.
L2_REL_TOL = 2e-4
# Serving vs the plain path on the card (no kernels; bf16 attention scores
# as the tpu_default einsum path has them): bf16 roundings 12 layers deep
# move imputed probabilities by ~1e-3 on average, ~1e-2 at most.
PROB_MEAN_TOL = 5e-3
PROB_MAX_TOL = 0.05


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


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    ms = time_ms(lambda: attention(q, k, v, scale), 20)
    plain_ms = time_ms(lambda: attention_plain(q, k, v, scale), 3, 1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), 20)
    b, h, l, hd = ATTN_SHAPE
    b_ms, by = bound(4 * b * h * l * hd * 2, 4 * b * h * l * l * hd)
    print(f"attention: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {lib_ms:.4f} (scaled_dot_product_attention) "
          f"bound_ms {b_ms:.4f} ({by})")
    return {"name": "attention", "route": "cuda",
            "source": "rag_snvbert_tpu_torch/csrc/attention.cu",
            "replaces": "rag_snvbert_tpu/models/transformer.py:99",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
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
          f"{lib_ms:.4f} (matmul+topk) bound_ms {b_ms:.4f} ({by})")

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
            "l2_topk": batches * len(targets)}
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
    if profile:
        profile_request(svc, targets[1][1])
    return counts


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
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile: request wall {wall_ms:.1f} ms, device kernels "
          f"{busy_ms:.1f} ms, device idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
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
    for name, rep in report.items():
        regs = [ln.strip() for ln in rep["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}: {rep['seconds']:.2f} s; " + "; ".join(regs))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [phase_attention(gen)]
    torch.cuda.empty_cache()
    kernels.append(phase_l2(gen))
    torch.cuda.empty_cache()
    counts = phase_serving(profile="--profile" in sys.argv[1:])
    for kern in kernels:
        kern["launches"] = counts[kern["name"]]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
