"""Synthetic haplotype-panel generator for tests, demos and the chip smoke.

Numpy copy of ``make_bundle`` and ``make_calibrated_bundle`` from
rag_snvbert_tpu/io/synthetic.py: the same seed gives the same arrays.
``make_bundle`` draws haplotypes from per-population founder haplotypes
with mutation noise, so nearest-neighbour retrieval is meaningful;
``make_calibrated_bundle`` is the mini-coalescent with a neutral site
frequency spectrum and linkage disequilibrium that the convergence run and
the ceiling tool use.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .freq import FreqTable, build_freq_matrix
from .panel import PanelData
from .vcf import VCFData
from .vocab import Vocab
from .windows import Window


@dataclasses.dataclass
class SyntheticBundle:
    train: VCFData
    ref: VCFData
    panel: PanelData       # for train samples
    ref_panel: PanelData
    freq: FreqTable
    window: Window
    vocab: Vocab
    # Generative internals of make_calibrated_bundle (None for make_bundle):
    # founder matrix, genetic map and copying-process parameters, read by
    # tools/oracle_ceiling.py's Li & Stephens decoder.  Exposing them does
    # not touch the rng stream.
    truth: dict | None = None


def _founders(rng, n_pops, n_sites, n_founders_per_pop=4, maf_low=0.02):
    """Per-pop founder haplotypes over a shared site frequency spectrum."""
    base_af = rng.beta(0.3, 0.9, n_sites).clip(maf_low, 1 - maf_low)
    founders = []
    for _ in range(n_pops):
        pop_shift = rng.normal(0, 0.12, n_sites)
        af = np.clip(base_af + pop_shift, 0.01, 0.99)
        founders.append(rng.random((n_founders_per_pop, n_sites)) < af)
    return founders


def _draw_haps(rng, founders_p, n_haps, mutation_rate=0.01, crossover=3):
    """Mosaic-of-founders haplotypes with point mutations."""
    nf, n_sites = founders_p.shape
    out = np.empty((n_haps, n_sites), np.int8)
    for h in range(n_haps):
        cuts = np.sort(rng.integers(1, n_sites, crossover))
        bounds = np.concatenate([[0], cuts, [n_sites]])
        for b in range(len(bounds) - 1):
            f = rng.integers(0, nf)
            out[h, bounds[b]:bounds[b + 1]] = founders_p[f, bounds[b]:bounds[b + 1]]
        flips = rng.random(n_sites) < mutation_rate
        out[h] = np.where(flips, 1 - out[h], out[h])
    return out


# --------------------------------------------------------------------------
# Calibrated generator: a mini-coalescent whose
# output matches the two statistics that make 1000G-style panels hard —
# a neutral site-frequency spectrum (P(derived count = i) ~ 1/i, so most
# sites are RARE) and distance-dependent linkage disequilibrium (tree
# turnover along a recombination-rate mosaic with hotspots).  The flat
# founders+3-crossover+1%-noise generator above stays for fast unit tests;
# this one feeds the quality gates and the full-scale convergence runs,
# where rare-variant F1 (the reference's optimization target,
# src/main/pretrain_with_val_optimized.py:281-310) must be measurable.
#
# Shape of the simulator:
#   1. Kingman coalescent over F "founder" haplotypes (structured: pairs
#      in the same population coalesce first with high probability).
#      Each edge = (leaf set, branch length).
#   2. Sites are grouped into non-recombining blocks by a Poisson process
#      on the genetic map (base rate x hotspot mosaic).  Within a block,
#      every site drops its mutation on one edge chosen with probability
#      proportional to branch length -> neutral SFS, and nearby sites hit
#      the same tree -> LD that decays as exp(-rho*d) across blocks.
#   3. Cohort haplotypes are Li&Stephens-style mosaics of the founders
#      (switch points Poisson on the same map, founder choice biased to
#      the sample's population) plus a small private-mutation rate mu.
#      A rare allele carried by one founder is inherited by every cohort
#      haplotype that copies that founder across the site -> rare variants
#      are SHARED (imputable through LD), unlike flat flip noise.
#
# The imputation ceiling is set by mu: a private flip has no LD and can
# never be recovered, so hap-call F1 is bounded by roughly
# 1 - mu/mean_alt_rate.  mu defaults to 2e-4 (ceiling ~0.999), replacing
# the old generator's 1% noise floor that capped F1 at ~0.97.


def _coalescent_edges(rng, pop_of_leaf: np.ndarray, within_bias: float = 0.9
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Kingman coalescent over ``len(pop_of_leaf)`` leaves with structured
    (within-population-first) pair choice.

    Returns ``(leafsets [n_edges, F] bool, lengths [n_edges] float)`` —
    one edge per non-root lineage, length in coalescent units accrued
    while the lineage was active.  Placing mutations with probability
    proportional to ``lengths`` yields the neutral frequency spectrum
    E[#sites with i carriers] ~ 1/i."""
    f = len(pop_of_leaf)
    leafsets = np.eye(f, dtype=bool)          # [k, F] active lineages
    pops = np.asarray(pop_of_leaf).copy()
    lengths = np.zeros(f)
    done_sets, done_len = [], []
    k = f
    while k > 1:
        lengths[:k] += rng.exponential(2.0 / (k * (k - 1)))
        # structured pair choice, O(k): within-pop pairs (weighted by the
        # number of pairs each pop offers) with prob within_bias
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
        # merged lineage keeps slot i (inheriting pops[i]); slot j is
        # backfilled from the last active slot
        leafsets[i] |= leafsets[j]
        lengths[i] = 0.0
        leafsets[j], lengths[j], pops[j] = (leafsets[k - 1], lengths[k - 1],
                                            pops[k - 1])
        k -= 1
    return np.stack(done_sets), np.asarray(done_len)


def _genetic_map(rng, pos: np.ndarray, hotspot_every_bp: float = 60_000,
                 hotspot_strength: float = 25.0) -> np.ndarray:
    """Cumulative genetic distance at each site: background rate 1.0 per
    bp (arbitrary units) with a mosaic of ~hotspots (short intervals at
    ``hotspot_strength`` x background), the standard recombination-map
    shape (most crossover activity concentrated in narrow hotspots)."""
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


def _poisson_boundaries(rng, gmap: np.ndarray, mean_gd: float) -> np.ndarray:
    """Site indices starting each new segment of a Poisson process with
    mean inter-event genetic distance ``mean_gd`` (index 0 always)."""
    total = gmap[-1]
    n_ev = rng.poisson(total / mean_gd) if total > 0 else 0
    events = np.sort(rng.uniform(0.0, total, n_ev))
    idx = np.unique(np.searchsorted(gmap, events))
    return np.unique(np.concatenate([[0], idx[idx < len(gmap)]]))


def _founder_matrix(rng, pos, gmap, pop_of_founder, block_gd):
    """[n_sites, F] int8 founder alleles: per non-recombining block, one
    coalescent tree; per site, one mutation on a branch-length-weighted
    edge."""
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
    """Li&Stephens-style cohort haplotypes: mosaic copies of ``founders``
    ([n_sites, F]) with Poisson switch points on the genetic map, founder
    choice ~ ``weights``, plus private mutations at rate ``mu``."""
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


def make_calibrated_bundle(n_train_samples: int = 24,
                           n_ref_samples: int = 40,
                           n_sites: int = 300, n_windows: int = 3,
                           n_pops: int = 3, n_founders: int = 96,
                           mean_gap_bp: int = 140,
                           block_kb: float = 30.0, switch_kb: float = 150.0,
                           mu: float = 2e-4, seed: int = 0
                           ) -> SyntheticBundle:
    """1000G-chr21-calibrated synthetic bundle (see module comment above).

    Defaults: ~140 bp mean site spacing (chr21 SNV density), ~30 kb LD
    blocks, ~150 kb copying segments, mu=2e-4 private noise (F1 ceiling
    ~0.999).  With the neutral SFS over ``n_founders`` leaves, roughly
    half of all sites land in the rare bin (cohort MAF < 0.05), matching
    the 1000G shape the reference's rare-variant F1 story depends on."""
    rng = np.random.default_rng(seed)
    n_pops = min(n_pops, n_train_samples)
    pops = [f"POP{i}" for i in range(n_pops)]
    pop_of_founder = np.arange(n_founders) % n_pops

    gaps = rng.geometric(1.0 / mean_gap_bp, n_sites - 1)
    positions = (10_000 + np.concatenate([[0], np.cumsum(gaps)])
                 ).astype(np.int64)
    gmap = _genetic_map(rng, positions)
    # calibrate Poisson rates: genetic units are (bp x rate>=1), so convert
    # kb targets using the map's realized mean rate per bp.
    per_bp = gmap[-1] / max(positions[-1] - positions[0], 1)
    founders = _founder_matrix(rng, positions, gmap, pop_of_founder,
                               block_gd=block_kb * 1e3 * per_bp)

    def cohort(n_samples, prefix):
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
        return gt, [f"{prefix}{s:04d}" for s in range(n_samples)], labels

    gt_tr, s_tr, lab_tr = cohort(n_train_samples, "TR")
    gt_rf, s_rf, lab_rf = cohort(n_ref_samples, "RF")

    def vcf_of(gt, samples):
        n = gt.shape[0]
        return VCFData(gt=gt, pos=positions.copy(),
                       chrom=np.asarray(["21"] * n, object),
                       ref=np.asarray(["A"] * n, object),
                       alt=np.asarray(["G"] * n, object),
                       ids=np.asarray(["."] * n, object),
                       samples=list(samples))

    panel = PanelData.from_lists(s_tr, lab_tr)
    ref_panel = PanelData.from_lists(s_rf, lab_rf)
    pop_class = np.asarray([panel.pop_to_class[p] for p in lab_rf])
    freq = FreqTable(build_freq_matrix(gt_rf, pop_class, n_pops), positions)

    per = n_sites // n_windows
    starts = np.arange(n_windows) * per
    ends = np.where(np.arange(n_windows) == n_windows - 1, n_sites,
                    starts + per)
    window = Window(np.stack([starts, ends], axis=1).astype(np.int64))
    vocab = Vocab.from_panel_pops(lab_tr)
    per_bp_rate = per_bp
    pop_weights = {}
    for p, name in enumerate(pops):
        w = np.where(pop_of_founder == p, 0.95, 0.05)
        pop_weights[name] = w / w.sum()
    truth = {"founders": founders, "gmap": gmap,
             "switch_gd": switch_kb * 1e3 * per_bp_rate,
             "block_gd": block_kb * 1e3 * per_bp_rate, "mu": mu,
             "per_bp": per_bp_rate,
             "pop_of_founder": pop_of_founder, "pop_weights": pop_weights}
    return SyntheticBundle(train=vcf_of(gt_tr, s_tr), ref=vcf_of(gt_rf, s_rf),
                           panel=panel, ref_panel=ref_panel, freq=freq,
                           window=window, vocab=vocab, truth=truth)


def make_bundle(n_train_samples: int = 24, n_ref_samples: int = 40,
                n_sites: int = 300, n_windows: int = 3, n_pops: int = 3,
                seed: int = 0) -> SyntheticBundle:
    rng = np.random.default_rng(seed)
    # The panel (and its pop->class map) is derived from the train cohort,
    # so a pop with no train sample cannot exist in the bundle — cap
    # n_pops for degenerate tiny cohorts (e.g. 2-sample dry runs).
    n_pops = min(n_pops, n_train_samples)
    pops = [f"POP{i}" for i in range(n_pops)]
    founders = _founders(rng, n_pops, n_sites)

    def make_cohort(n_samples, prefix):
        labels = [pops[i % n_pops] for i in range(n_samples)]
        gt = np.zeros((n_sites, n_samples, 2), np.int8)
        for s, lab in enumerate(labels):
            p = pops.index(lab)
            haps = _draw_haps(rng, founders[p], 2)
            gt[:, s, 0] = haps[0]
            gt[:, s, 1] = haps[1]
        samples = [f"{prefix}{s:04d}" for s in range(n_samples)]
        positions = np.sort(rng.choice(np.arange(10_000, 10_000 + 50 * n_sites),
                                       n_sites, replace=False)).astype(np.int64)
        return gt, samples, labels, positions

    # Shared positions so train/ref intersect fully (the reference expects
    # near-complete overlap; partial overlap is exercised separately).
    gt_tr, s_tr, lab_tr, positions = make_cohort(n_train_samples, "TR")
    gt_rf = np.zeros((n_sites, n_ref_samples, 2), np.int8)
    lab_rf = [pops[i % n_pops] for i in range(n_ref_samples)]
    for s, lab in enumerate(lab_rf):
        p = pops.index(lab)
        haps = _draw_haps(rng, founders[p], 2)
        gt_rf[:, s, 0] = haps[0]
        gt_rf[:, s, 1] = haps[1]
    s_rf = [f"RF{s:04d}" for s in range(n_ref_samples)]

    def vcf_of(gt, samples):
        n = gt.shape[0]
        return VCFData(gt=gt, pos=positions.copy(),
                       chrom=np.asarray(["21"] * n, object),
                       ref=np.asarray(["A"] * n, object),
                       alt=np.asarray(["G"] * n, object),
                       ids=np.asarray(["."] * n, object),
                       samples=list(samples))

    panel = PanelData.from_lists(s_tr, lab_tr)
    ref_panel = PanelData.from_lists(s_rf, lab_rf)

    pop_class = np.asarray([panel.pop_to_class[p] for p in lab_rf])
    freq = FreqTable(build_freq_matrix(gt_rf, pop_class, n_pops), positions)

    per = n_sites // n_windows
    starts = np.arange(n_windows) * per
    ends = np.where(np.arange(n_windows) == n_windows - 1, n_sites,
                    starts + per)
    window = Window(np.stack([starts, ends], axis=1).astype(np.int64))

    vocab = Vocab.from_panel_pops(lab_tr)
    return SyntheticBundle(train=vcf_of(gt_tr, s_tr), ref=vcf_of(gt_rf, s_rf),
                           panel=panel, ref_panel=ref_panel, freq=freq,
                           window=window, vocab=vocab)
