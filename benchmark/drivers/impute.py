"""Closed-loop cohort imputation with one client: ``Imputer.impute`` of a
cohort of target samples over every window of the panel, cohort after
cohort until the window closes.

The targets carry one genotyping-array pattern (``array_share`` of the
sites kept, at places drawn from the seed); the others are missing and
imputed.  Set-up makes ``cohorts`` cohorts of ``cohort_samples``
samples from the panel's founders and imputes the first (every shape the
window uses: the window contexts, batch ``batch_size``, pipeline depth
``pipeline_depth``); the window cycles through the others, then the first again.
``impute_genotypes_per_s`` is the missing genotypes (sites x samples) of
the calls returned in the window over its seconds.

The check frees the program and has the reference impute ``check_samples``
samples of the window's last cohort (drawn from the seed) in every
window; per answer (one sample in one window) the mean over its missing
sites of the widest gap among its probabilities is compared, worst
answer first."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import panel as panel_mod
from benchmark import program, weights
from benchmark.reference import infer as ref_infer
from benchmark.reference import model as ref_model


def array_pattern(run, n_sites: int) -> np.ndarray:
    """The sites the genotyping array keeps: ``array_share`` of them
    exactly (so every seed imputes as many), at places drawn from the
    seed."""
    rng = np.random.default_rng([run.seed, 1])
    keep = np.zeros(n_sites, bool)
    keep[rng.choice(n_sites, int(round(float(run.param("array_share"))
                                       * n_sites)), replace=False)] = True
    return keep


def setup(run) -> dict:
    from rag_snvbert_tpu_torch.infer.imputer import Imputer

    rc = program.preset(run)
    w = run.param("n_windows")
    spw = run.param("sites_per_window")
    n_cohorts = int(run.param("cohorts"))
    panel = panel_mod.make_panel(
        n_train_samples=3, n_ref_samples=run.param("n_ref_samples"),
        n_sites=w * spw, n_windows=w, seed=run.seed,
        target_cohorts=(int(run.param("cohort_samples")),) * n_cohorts)
    present = array_pattern(run, w * spw)
    refs = [f"RF{i:04d}" for i in range(panel.ref_gt.shape[1])]
    ref_vcf = program.vcf(panel.ref_gt, panel.positions, refs)
    model = program.build_model(rc, program.vocab_of(panel).size, run.seed,
                                run.device)
    imputer = Imputer(model, ref_vcf, program.freq_table(panel),
                      window_len=spw, seq_len=rc.model.seq_len,
                      rag_k=rc.rag_k, ref_pad_haps=run.param("ref_pad_haps"),
                      batch_size=int(run.param("batch_size")),
                      pipeline_depth=int(run.param("pipeline_depth")),
                      device=run.device, rag_mode=rc.model.rag_mode)
    targets = []
    for c, gt in enumerate(panel.targets):
        names = [f"TG{c}_{i:04d}" for i in range(gt.shape[1])]
        targets.append(program.vcf(gt[present], panel.positions[present],
                                   names))
    imputer.impute(targets[0])                       # the warm-up
    return {"imputer": imputer, "panel": panel, "present": present,
            "targets": targets, "rc": rc, "vocab": imputer.model.bert
            .embedding.Embed_0.num_embeddings}


def window(run, state, seconds: float) -> dict:
    imputer, targets = state["imputer"], state["targets"]
    n_missing = int((~state["present"]).sum())
    bs = int(run.param("batch_size"))
    n_win = len(imputer.windows)
    calls = genotypes = samples = batches = 0
    t0 = time.perf_counter()
    while True:
        # the warm-up's cohort 0 last in the cycle
        c = (1 + calls) % len(targets)
        with torch.profiler.record_function("bench.impute"):
            res = imputer.impute(targets[c])      # numpy: the work is done
        n = targets[c].n_samples
        calls += 1
        samples += n
        genotypes += n_missing * n
        batches += n_win * -(-n // bs)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    state["last"] = (c, res)
    counts = {"impute_calls": calls, "samples": samples,
              "genotypes": genotypes, "batches": batches,
              "window_contexts": calls * n_win, "batch_size": bs,
              "context_rows": int(run.param("ref_pad_haps")),
              "seq_len": int(state["rc"].model.seq_len)}
    return {"metrics": {"impute_genotypes_per_s": genotypes / elapsed},
            "counts": counts, "attempted": samples, "failed": 0,
            "window_s": elapsed}


def reference_probs(run, state, cohort: int, cols: np.ndarray,
                    precision=None) -> list[dict]:
    """The reference's probabilities of samples ``cols`` of ``cohort``,
    one dict per window."""
    panel, rc = state["panel"], state["rc"]
    mb = program.model_block(run)
    ref = ref_model.from_config(mb, state["vocab"]).to(run.device)
    weights.fill(ref, run.seed)
    ref_model.set_precision(ref, precision)
    out = []
    for w, (s, e) in enumerate(panel.window_info):
        out.append(ref_infer.impute_window(
            ref, panel, w, panel.targets[cohort][s:e][:, cols],
            state["present"][s:e], mb["rag_mode"],
            int(run.param("ref_pad_haps")), rc.model.seq_len, run.device))
    del ref
    program.free_cuda()
    return out


def program_probs(state, res, cols) -> list[dict]:
    out = []
    for s, e in state["panel"].window_info:
        out.append({"hap1": res.hap1_prob[s:e][:, cols].astype(np.float64),
                    "hap2": res.hap2_prob[s:e][:, cols].astype(np.float64),
                    "gt": res.gt_prob[s:e][:, cols].astype(np.float64)})
    return out


def gaps(state, got: list, want: list) -> dict:
    per, widest = [], 0.0
    for w, (s, e) in enumerate(state["panel"].window_info):
        miss = ~state["present"][s:e]
        per.append(ref_infer.answer_gaps(got[w], want[w], miss))
        widest = max(widest, ref_infer.widest_gap(got[w], want[w], miss))
    return {"answer": float(np.max(np.concatenate(per))), "widest": widest}


def check_columns(run, n: int) -> np.ndarray:
    rng = np.random.default_rng([run.seed, 2])
    k = min(int(run.param("check_samples")), n)
    return np.sort(rng.choice(n, k, replace=False))


def calibrate(run, state, control: str | None, faults: bool) -> dict:
    """The program's readings on one call (cohort 1), and the control's
    (the reference in ``control`` precision in the program's place)."""
    res = state["imputer"].impute(state["targets"][1])
    del state["imputer"]
    program.free_cuda()
    cols = check_columns(run, state["targets"][1].n_samples)
    want = reference_probs(run, state, 1, cols)
    out = {"program": gaps(state, program_probs(state, res, cols), want)}
    if control:
        out["control"] = gaps(state, reference_probs(run, state, 1, cols,
                                                     control), want)
    return out


def check(run, state) -> list[dict]:
    cohort, res = state.pop("last")
    del state["imputer"]
    program.free_cuda()
    cols = check_columns(run, state["targets"][cohort].n_samples)
    got = program_probs(state, res, cols)
    want = reference_probs(run, state, cohort, cols)
    limits = run.param("limits")
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in gaps(state, got, want).items() if k in limits]
