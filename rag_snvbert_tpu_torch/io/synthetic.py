"""Synthetic haplotype-panel generator for tests, demos and the chip smoke.

Numpy copy of ``make_bundle`` from rag_snvbert_tpu/io/synthetic.py: the same
seed gives the same arrays.  Haplotypes are drawn from per-population
founder haplotypes with mutation noise, so nearest-neighbour retrieval is
meaningful.
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
