"""The calibrated synthetic panel: a frozen copy of
``rag_snvbert_tpu_torch/io/synthetic.py::make_calibrated_bundle`` (numpy
only, the same seed gives the same arrays as that function), returning
plain arrays instead of the program's classes, plus extra target cohorts
drawn from the same founders after it.

A mini-coalescent: a neutral site-frequency spectrum (most sites rare)
and linkage disequilibrium from non-recombining blocks on a genetic map
with hotspots; cohort haplotypes are Li & Stephens mosaics of 96 founder
haplotypes, biased to the sample's population, plus private mutations at
``mu``.  Positions are ~140 bp apart, chr21's SNV density.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Panel:
    positions: np.ndarray          # [S] int64
    train_gt: np.ndarray           # [S, n_train, 2] int8
    train_pops: list[str]
    ref_gt: np.ndarray             # [S, n_ref, 2] int8
    ref_pops: list[str]
    freq: np.ndarray               # [4, P + 1, S] float32 (REF, HET, HOM, AF)
    window_info: np.ndarray        # [W, 2] int64 site index ranges
    targets: list[np.ndarray]      # extra cohorts, [S, n, 2] int8 each
    target_pops: list[list[str]]


def _coalescent_edges(rng, pop_of_leaf, within_bias=0.9):
    f = len(pop_of_leaf)
    leafsets = np.eye(f, dtype=bool)
    pops = np.asarray(pop_of_leaf).copy()
    lengths = np.zeros(f)
    done_sets, done_len = [], []
    k = f
    while k > 1:
        lengths[:k] += rng.exponential(2.0 / (k * (k - 1)))
        u, counts = np.unique(pops[:k], return_counts=True)
        w = counts * (counts - 1)
        if w.sum() > 0 and rng.random() < within_bias:
            p = u[rng.choice(len(u), p=w / w.sum())]
            i, j = rng.choice(np.flatnonzero(pops[:k] == p), 2,
                              replace=False)
        else:
            i, j = rng.choice(k, 2, replace=False)
        i, j = min(i, j), max(i, j)
        done_sets += [leafsets[i].copy(), leafsets[j].copy()]
        done_len += [lengths[i], lengths[j]]
        leafsets[i] |= leafsets[j]
        lengths[i] = 0.0
        leafsets[j], lengths[j], pops[j] = (leafsets[k - 1], lengths[k - 1],
                                            pops[k - 1])
        k -= 1
    return np.stack(done_sets), np.asarray(done_len)


def _genetic_map(rng, pos, hotspot_every_bp=60_000, hotspot_strength=25.0):
    span = int(pos[-1] - pos[0]) + 1
    n_hot = max(1, int(span / hotspot_every_bp))
    starts = rng.uniform(pos[0], pos[-1], n_hot)
    widths = rng.uniform(500, 2_000, n_hot)
    gaps = np.diff(pos).astype(np.float64)
    mids = (pos[1:] + pos[:-1]) / 2.0
    rate = np.ones_like(gaps)
    for s, w in zip(starts, widths):
        rate[(mids >= s) & (mids < s + w)] += hotspot_strength
    return np.concatenate([[0.0], np.cumsum(gaps * rate)])


def _poisson_boundaries(rng, gmap, mean_gd):
    total = gmap[-1]
    n_ev = rng.poisson(total / mean_gd) if total > 0 else 0
    events = np.sort(rng.uniform(0.0, total, n_ev))
    idx = np.unique(np.searchsorted(gmap, events))
    return np.unique(np.concatenate([[0], idx[idx < len(gmap)]]))


def _founder_matrix(rng, pos, gmap, pop_of_founder, block_gd):
    n_sites, f = len(pos), len(pop_of_founder)
    out = np.empty((n_sites, f), np.int8)
    starts = _poisson_boundaries(rng, gmap, block_gd)
    ends = np.concatenate([starts[1:], [n_sites]])
    for s, e in zip(starts, ends):
        leafsets, lengths = _coalescent_edges(rng, pop_of_founder)
        pr = lengths / lengths.sum()
        picks = rng.choice(len(lengths), size=e - s, p=pr)
        out[s:e] = leafsets[picks].astype(np.int8)
    return out


def _copy_haps(rng, founders, gmap, weights, n_haps, switch_gd, mu):
    n_sites, f = founders.shape
    out = np.empty((n_haps, n_sites), np.int8)
    sites = np.arange(n_sites)
    for h in range(n_haps):
        starts = _poisson_boundaries(rng, gmap, switch_gd)
        seg_len = np.diff(np.concatenate([starts, [n_sites]]))
        fids = rng.choice(f, size=len(starts), p=weights)
        fmap = np.repeat(fids, seg_len)
        hap = founders[sites, fmap]
        flips = rng.random(n_sites) < mu
        out[h] = np.where(flips, 1 - hap, hap)
    return out


def build_freq_matrix(gt, pop_class, n_pops):
    """freq[4, n_pops + 1, n_sites]: REF, HET, HOM, AF per population,
    index ``n_pops`` the global pool (``io/freq.py``'s layout)."""
    n_sites, n_samples, _ = gt.shape
    dosage = gt.sum(axis=2)
    out = np.zeros((4, n_pops + 1, n_sites), dtype=np.float32)

    def fill(pop_idx, cols):
        n = max(len(cols), 1)
        d = dosage[:, cols]
        out[0, pop_idx] = (d == 0).sum(axis=1) / n
        out[1, pop_idx] = (d == 1).sum(axis=1) / n
        out[2, pop_idx] = (d == 2).sum(axis=1) / n
        out[3, pop_idx] = d.sum(axis=1) / (2 * n)

    for p in range(n_pops):
        fill(p, np.flatnonzero(pop_class == p))
    fill(n_pops, np.arange(n_samples))
    return out


def make_panel(n_train_samples=24, n_ref_samples=40, n_sites=300,
               n_windows=3, n_pops=3, n_founders=96, mean_gap_bp=140,
               block_kb=30.0, switch_kb=150.0, mu=2e-4, seed=0,
               target_cohorts=(), ) -> Panel:
    """``make_calibrated_bundle``'s arrays for these arguments, then one
    extra cohort of ``n`` samples for each ``n`` of ``target_cohorts``,
    drawn on after the reference cohort from the same generator."""
    rng = np.random.default_rng(seed)
    n_pops = min(n_pops, n_train_samples)
    pops = [f"POP{i}" for i in range(n_pops)]
    pop_of_founder = np.arange(n_founders) % n_pops

    gaps = rng.geometric(1.0 / mean_gap_bp, n_sites - 1)
    positions = (10_000 + np.concatenate([[0], np.cumsum(gaps)])
                 ).astype(np.int64)
    gmap = _genetic_map(rng, positions)
    per_bp = gmap[-1] / max(positions[-1] - positions[0], 1)
    founders = _founder_matrix(rng, positions, gmap, pop_of_founder,
                               block_gd=block_kb * 1e3 * per_bp)

    def cohort(n_samples):
        labels = [pops[i % n_pops] for i in range(n_samples)]
        gt = np.empty((n_sites, n_samples, 2), np.int8)
        for p in range(n_pops):
            members = [s for s, lab in enumerate(labels) if lab == pops[p]]
            if not members:
                continue
            w = np.where(pop_of_founder == p, 0.95, 0.05)
            w = w / w.sum()
            haps = _copy_haps(rng, founders, gmap, w, 2 * len(members),
                              switch_gd=switch_kb * 1e3 * per_bp, mu=mu)
            for i, s in enumerate(members):
                gt[:, s, 0] = haps[2 * i]
                gt[:, s, 1] = haps[2 * i + 1]
        return gt, labels

    gt_tr, lab_tr = cohort(n_train_samples)
    gt_rf, lab_rf = cohort(n_ref_samples)
    targets, target_pops = [], []
    for n in target_cohorts:
        gt, lab = cohort(n)
        targets.append(gt)
        target_pops.append(lab)

    pop_to_class: dict[str, int] = {}
    for p in lab_tr:
        pop_to_class.setdefault(p, len(pop_to_class))
    pop_class = np.asarray([pop_to_class[p] for p in lab_rf])
    freq = build_freq_matrix(gt_rf, pop_class, n_pops)

    per = n_sites // n_windows
    starts = np.arange(n_windows) * per
    ends = np.where(np.arange(n_windows) == n_windows - 1, n_sites,
                    starts + per)
    window_info = np.stack([starts, ends], axis=1).astype(np.int64)
    return Panel(positions=positions, train_gt=gt_tr, train_pops=lab_tr,
                 ref_gt=gt_rf, ref_pops=lab_rf, freq=freq,
                 window_info=window_info, targets=targets,
                 target_pops=target_pops)
