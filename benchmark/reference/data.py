"""Tokens, masks, features and batches from the panel's arrays, in numpy:
the semantics of the program's data pipeline written out plainly.

Token ids: PAD 0, SOS 2, EOS 3, MASK 4, allele ``a`` is ``5 + a``; a
window of ``n`` sites is ``[SOS, tokens..., EOS, PAD...]`` of length
``L``, so site ``i`` sits at slot ``i + 1``.  The AF-guided training mask
masks a site with probability 0.7 where its global allele frequency is
below 0.05 and at the curriculum rate (0.30 + 0.10 a level, at most 0.80)
elsewhere, from ``default_rng(seed * 10000 + window)``.  An epoch (seed
``epoch``) visits the windows in ``default_rng(epoch).permutation`` order
and, in each, the samples in the next permutation of the same generator,
``batch`` at a time.
"""

from __future__ import annotations

import numpy as np

PAD, SOS, EOS, MASK, ALLELE = 0, 2, 3, 4, 5
MASK_RATES = (0.30, 0.40, 0.50, 0.60, 0.70, 0.80)
REF, HET, HOM, AF = 0, 1, 2, 3


def pad(seq, L):
    seq = np.asarray(seq)
    out = np.zeros(seq.shape[:-1] + (L,), seq.dtype)
    out[..., 1: 1 + seq.shape[-1]] = seq
    return out


def tokens(alleles, L, mask=None):
    alleles = np.asarray(alleles)
    n = alleles.shape[-1]
    out = np.full(alleles.shape[:-1] + (L,), PAD, np.int64)
    out[..., 0] = SOS
    out[..., 1: 1 + n] = ALLELE + alleles
    if n + 1 < L:
        out[..., n + 1] = EOS
    if mask is not None:
        out = np.where(np.asarray(mask).astype(bool), MASK, out)
    return out


def normalized_positions(pos):
    pos = np.asarray(pos, np.float64)
    span = pos.max() - pos.min()
    if span == 0:
        return np.zeros_like(pos, np.float32)
    return ((pos - pos.min()) / span).astype(np.float32)


def train_mask(af, level, seed, window):
    rate = MASK_RATES[min(level, len(MASK_RATES) - 1)]
    probs = np.where(np.asarray(af) < 0.05, 0.7, rate).astype(np.float32)
    rng = np.random.default_rng(seed * 10000 + window)
    return (rng.random(len(af)) < probs).astype(np.int64)


class Windows:
    """The panel's windows: sites, frequencies and population features."""

    def __init__(self, panel, L: int = 1030):
        self.p, self.L = panel, L
        classes: dict[str, int] = {}
        for name in panel.train_pops:
            classes.setdefault(name, len(classes))
        self.classes = classes

    def sites(self, w):
        s, e = self.p.window_info[w]
        return slice(int(s), int(e))

    def af(self, w):
        return self.p.freq[AF, -1, self.sites(w)]

    def features(self, w, pop_class):
        """``{af, af_p, ref, het, hom, pos}`` ``[L]`` of window ``w`` for
        a sample of population class ``pop_class``."""
        sl, L, f = self.sites(w), self.L, self.p.freq
        return {"af": pad(f[AF, -1, sl], L), "af_p": pad(f[AF, pop_class, sl], L),
                "ref": pad(f[REF, pop_class, sl], L),
                "het": pad(f[HET, pop_class, sl], L),
                "hom": pad(f[HOM, pop_class, sl], L),
                "pos": pad(normalized_positions(self.p.positions[sl]), L)}

    def ref_tokens(self, w, pad_to):
        """Complete reference haplotype tokens ``[pad_to, L]`` (rows past
        the panel are PAD) and the ``[pad_to]`` valid flags."""
        raw = self.p.ref_gt[self.sites(w)]
        raw = raw.reshape(raw.shape[0], -1).T          # sample-major haps
        toks = tokens(raw, self.L)
        n = toks.shape[0]
        out = np.zeros((max(pad_to, n), self.L), np.int64)
        out[:n] = toks
        valid = np.zeros(out.shape[0], bool)
        valid[:n] = True
        return out, valid

    def train_batch(self, w, ids, level, seed):
        """The training batch of samples ``ids`` of window ``w``."""
        sl, L = self.sites(w), self.L
        h1 = self.p.train_gt[sl, :, 0][:, ids].T.astype(np.int64)
        h2 = self.p.train_gt[sl, :, 1][:, ids].T.astype(np.int64)
        mask = pad(train_mask(self.af(w), level, seed, w), L)
        out = {"hap_1": tokens(h1, L, mask), "hap_2": tokens(h2, L, mask),
               "hap_1_label": pad(h1, L), "hap_2_label": pad(h2, L),
               "gt_label": pad((h1 << 1) + h2, L),
               "mask": np.broadcast_to(mask, (len(ids), L)).copy(),
               "window_mask": mask}
        cls = [self.classes[self.p.train_pops[i]] for i in ids]
        feats = [self.features(w, c) for c in cls]
        for k in feats[0]:
            out[k] = np.stack([f[k] for f in feats]).astype(np.float32)
        return out


def epoch_order(n_windows, n_samples, batch, epoch):
    """``[(window, sample ids)]`` of a training epoch, in order (whole
    batches only: the cells' sample counts divide by their batch)."""
    if n_samples % batch:
        raise ValueError(f"{n_samples} samples do not divide into batches "
                         f"of {batch}")
    rng = np.random.default_rng(epoch)
    out = []
    for w in rng.permutation(n_windows):
        ids = rng.permutation(n_samples)
        for i in range(0, n_samples, batch):
                out.append((int(w), ids[i: i + batch]))
    return out
