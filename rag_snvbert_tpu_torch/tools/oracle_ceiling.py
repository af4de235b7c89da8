"""Measure the imputation CEILING of the calibrated synthetic panel.

The port of tools/oracle_ceiling.py: numpy over the port's
``data/masking.py`` and ``train/metrics.py``; at the same flags its JSON
(timing aside) is the JAX tool's.  The convergence run's validation
rare-bin F1 is read against what is achievable on this panel.  Three
oracles, strongest to weakest, all with the trainer's exact validation
protocol (same bundle, same stratified validation split, same per-window
AF-guided masks at level VAL_LEVEL and seed VAL_SEED, same hap-level macro
F1 counters with the rare/common MAF split):

1. ``ls_truth``: Li & Stephens forward-backward posterior decoding of each
   validation haplotype against the TRUE founder matrix with the TRUE
   generative parameters (``SyntheticBundle.truth``): approximately the
   Bayes posterior of the generative process, so no trainable model beats
   it in expectation.  THE ceiling.
2. ``ls_panel``: the same decoder against the observable reference panel
   haplotypes with moment-matched switch/error rates: classical statistical
   imputation (Beagle/IMPUTE-class), the strongest non-cheating baseline.
3. ``nn_copy``: 1-nearest-neighbour copying: the panel haplotype with the
   fewest mismatches on the window's observed sites, its alleles copied at
   the masked sites; the ceiling of whole-window retrieval with k = 1.

Decoding is per window (the model's 1020-site context).  Flags mirror
``tools/run_convergence.py``, so panel and split are the convergence run's.

    python -m rag_snvbert_tpu_torch.tools.oracle_ceiling --windows 331 \
        --samples 1004 --out artifacts/convergence_port/oracle_ceiling.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..config import PRESETS
from ..data import masking
from ..data.pipeline import WindowDataset
from ..io.synthetic import make_calibrated_bundle
from ..train.metrics import RARE_MAF_THRESHOLD, f1_from_counts


# ---------------------------------------------------------------------------
# Li&Stephens forward-backward, vectorized over haplotypes.


def ls_posterior_p1(states: np.ndarray, gmap_w: np.ndarray, obs: np.ndarray,
                    observed: np.ndarray, weights: np.ndarray,
                    switch_gd: float, mu: float) -> np.ndarray:
    """Posterior P(allele = 1) at every site for every query haplotype.

    states   [n, F] int8   copying-state haplotypes (founders or panel)
    gmap_w   [n] float     cumulative genetic-map position per site
    obs      [H, n] int8   query alleles (only ``observed`` columns used)
    observed [n] bool      True = site is unmasked (an observation)
    weights  [H, F] float  per-query prior over states (rows sum to 1)
    switch_gd              mean genetic distance between copy switches
    mu                     per-site private-mutation (emission error) rate

    The copying process is a continuous-time jump chain on the genetic
    map: P(no switch over d) = exp(-d / switch_gd); on a switch the new
    state ~ weights.  Emission: match w.p. 1-mu, mismatch w.p. mu;
    masked sites emit nothing.  Scaled forward-backward in float64;
    posterior allele probability folds the emission noise back in:
    P(a=1) = mu + (1 - 2 mu) * sum_f gamma_f * state_f.
    """
    n, F = states.shape
    H = obs.shape[0]
    s = states.T.astype(np.float64)                 # [F, n] for fancy cols
    stay = np.exp(-np.diff(gmap_w) / switch_gd)     # [n-1]

    def emission(i):
        if not observed[i]:
            return None                              # uninformative
        # [H, F]: 1-mu where state allele == obs allele else mu
        eq = s[:, i][None, :] == obs[:, i, None]
        return np.where(eq, 1.0 - mu, mu)

    # forward (alpha normalized to sum 1 per row at every site)
    alphas = np.empty((n, H, F))
    a = weights.copy()
    e = emission(0)
    if e is not None:
        a = a * e
    a /= a.sum(1, keepdims=True)
    alphas[0] = a
    for i in range(1, n):
        a = stay[i - 1] * a + (1.0 - stay[i - 1]) * weights
        e = emission(i)
        if e is not None:
            a = a * e
        a /= a.sum(1, keepdims=True)
        alphas[i] = a

    # backward (normalized per step; constants cancel in gamma)
    post1 = np.empty((H, n))
    b = np.ones((H, F))

    def fold(i, b):
        g = alphas[i] * b
        g /= g.sum(1, keepdims=True)
        post1[:, i] = mu + (1.0 - 2.0 * mu) * (g @ s[:, i])

    fold(n - 1, b)
    for i in range(n - 2, -1, -1):
        # b_i(f) = stay * e_{i+1}(f) b_{i+1}(f)
        #        + (1-stay) * sum_f' w(f') e_{i+1}(f') b_{i+1}(f')
        eb = b
        e = emission(i + 1)
        if e is not None:
            eb = eb * e
        b = (stay[i] * eb
             + (1.0 - stay[i]) * np.sum(weights * eb, axis=1, keepdims=True))
        b /= b.sum(1, keepdims=True)
        fold(i, b)
    return post1


# ---------------------------------------------------------------------------
# Host-side counters mirroring train/metrics.py (2-class hap counts).


def class_counts2(pred: np.ndarray, label: np.ndarray,
                  m: np.ndarray) -> dict[str, np.ndarray]:
    out = {"tp": np.zeros(2, np.int64), "fp": np.zeros(2, np.int64),
           "fn": np.zeros(2, np.int64)}
    for c in (0, 1):
        p = (pred == c) & m
        l = (label == c) & m
        out["tp"][c] = np.sum(p & l)
        out["fp"][c] = np.sum(p & ~l)
        out["fn"][c] = np.sum(~p & l)
    return out


def acc_counts(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def zeros2() -> dict:
    return {"tp": np.zeros(2, np.int64), "fp": np.zeros(2, np.int64),
            "fn": np.zeros(2, np.int64)}


class OracleMetrics:
    """Accumulates the trainer's hap/rare/common counters for one oracle."""

    def __init__(self):
        self.hap, self.rare, self.common = zeros2(), zeros2(), zeros2()
        self.correct = 0
        self.total = 0

    def update(self, pred, label, mask_sites, maf):
        m = np.broadcast_to(mask_sites, pred.shape)
        rare = m & np.broadcast_to(maf < RARE_MAF_THRESHOLD, pred.shape)
        common = m & np.broadcast_to(maf >= RARE_MAF_THRESHOLD, pred.shape)
        self.hap = acc_counts(self.hap, class_counts2(pred, label, m))
        self.rare = acc_counts(self.rare, class_counts2(pred, label, rare))
        self.common = acc_counts(self.common,
                                 class_counts2(pred, label, common))
        self.correct += int(np.sum((pred == label) & m))
        self.total += int(np.sum(m))

    def summary(self) -> dict:
        return {"hap_acc": self.correct / max(self.total, 1),
                "hap_f1": f1_from_counts(self.hap),
                "rare_f1": f1_from_counts(self.rare),
                "common_f1": f1_from_counts(self.common),
                "masked_calls": self.total}


def nn_copy_predict(panel_haps: np.ndarray, obs: np.ndarray,
                    observed: np.ndarray) -> np.ndarray:
    """1-NN copying: nearest panel hap by mismatch count on observed
    sites, alleles copied everywhere.  panel_haps [R, n], obs [H, n]."""
    A = obs[:, observed].astype(np.float64)          # [H, o]
    B = panel_haps[:, observed].astype(np.float64)   # [R, o]
    mism = A @ (1.0 - B.T) + (1.0 - A) @ B.T          # [H, R]
    nn = np.argmin(mism, axis=1)
    return panel_haps[nn]                             # [H, n]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tpu_default")
    ap.add_argument("--windows", type=int, default=331)
    ap.add_argument("--samples", type=int, default=1004)
    ap.add_argument("--ref-samples", type=int, default=1004)
    ap.add_argument("--val-fraction", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--val-level", type=int, default=masking.VAL_LEVEL)
    ap.add_argument("--val-seed", type=int, default=masking.VAL_SEED)
    ap.add_argument("--skip-ls-panel", action="store_true",
                    help="skip the slow panel-state decoder (F = 2S)")
    ap.add_argument("--panel-switch-kb", type=float, default=150.0,
                    help="copying-segment scale for the ls_panel decoder "
                    "(moment-matched to the generator's switch_kb)")
    ap.add_argument("--panel-mu", type=float, default=1e-3,
                    help="emission error for ls_panel (> generator mu: "
                    "panel haps carry their own private mutations)")
    ap.add_argument("--limit-windows", type=int, default=0,
                    help="if >0, decode only the first N windows of the "
                    "SAME full panel (the bundle is still built with "
                    "--windows, so sites/AF/masks are unchanged) — a "
                    "window-sampled estimate of the ceiling for decoders "
                    "too slow to run genome-wide on this host (ls_panel "
                    "is O(sites*haps*2S) per window)")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)

    run = PRESETS[args.preset]
    seq_len = run.model.seq_len
    win = seq_len - 10
    t0 = time.time()
    b = make_calibrated_bundle(n_train_samples=args.samples,
                               n_ref_samples=args.ref_samples,
                               n_sites=win * args.windows,
                               n_windows=args.windows, seed=args.seed)
    assert b.truth is not None
    print(f"panel built in {time.time() - t0:.0f}s", file=sys.stderr)
    _, val_ids = b.panel.split_stratified(args.val_fraction, seed=args.seed)
    val_ids = np.asarray(val_ids)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=seq_len)

    tr = b.truth
    founders = tr["founders"]                       # [n_sites, F]
    gmap = tr["gmap"]
    # per-val-hap copying prior (population-biased, as generated)
    labels = [b.panel.pop_list[i] for i in val_ids]
    w_rows = np.stack([tr["pop_weights"][lab] for lab in labels])  # [V, F]
    weights = np.repeat(w_rows, 2, axis=0)          # [H=2V, F]

    # observable panel haplotypes, [2S, n_sites] via site-major gt
    panel_gt = b.ref.gt                             # [n_sites, S, 2]
    panel_haps_all = panel_gt.reshape(panel_gt.shape[0], -1).T  # [2S, n]
    uniform_w = np.full((len(val_ids) * 2, panel_haps_all.shape[0]),
                        1.0 / panel_haps_all.shape[0])
    panel_switch_gd = args.panel_switch_kb * 1e3 * tr["per_bp"]

    oracles = {"ls_truth": OracleMetrics(), "nn_copy": OracleMetrics()}
    if not args.skip_ls_panel:
        oracles["ls_panel"] = OracleMetrics()

    t0 = time.time()
    for wi, meta in enumerate(ds.windows):
        if args.limit_windows and wi >= args.limit_windows:
            break
        sites = meta.site_slice.start + meta.valid_idx   # global site idx
        af = ds.window_af(meta)
        maf = np.minimum(af, 1.0 - af)
        raw_mask = masking.af_guided_mask(
            af, args.val_level, args.val_seed, meta.window_idx).astype(bool)
        observed = ~raw_mask
        if raw_mask.sum() == 0 or observed.sum() == 0:
            continue
        # val haplotypes for this window, [H, n]
        gt = b.train.gt[meta.site_slice][meta.valid_idx][:, val_ids]  # [n,V,2]
        haps = gt.transpose(1, 2, 0).reshape(-1, gt.shape[0])          # [2V,n]
        # oracle inputs observe the UNMASKED sites only
        p1 = ls_posterior_p1(founders[sites], gmap[sites], haps, observed,
                             weights, tr["switch_gd"], tr["mu"])
        oracles["ls_truth"].update((p1 > 0.5).astype(np.int8), haps,
                                   raw_mask, maf)
        pred_nn = nn_copy_predict(panel_haps_all[:, sites], haps, observed)
        oracles["nn_copy"].update(pred_nn, haps, raw_mask, maf)
        if "ls_panel" in oracles:
            p1p = ls_posterior_p1(panel_haps_all[:, sites].T, gmap[sites],
                                  haps, observed, uniform_w,
                                  panel_switch_gd, args.panel_mu)
            oracles["ls_panel"].update((p1p > 0.5).astype(np.int8), haps,
                                       raw_mask, maf)
        if (wi + 1) % 25 == 0:
            print(f"window {wi + 1}/{len(ds.windows)} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr)

    out = {"val_level": args.val_level, "val_seed": args.val_seed,
           "windows": args.windows, "val_samples": len(val_ids),
           "rare_maf_threshold": RARE_MAF_THRESHOLD,
           "oracles": {k: m.summary() for k, m in oracles.items()},
           "wall_seconds": round(time.time() - t0, 1)}
    js = json.dumps(out, indent=2)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js + "\n")
    return out


if __name__ == "__main__":
    main()
