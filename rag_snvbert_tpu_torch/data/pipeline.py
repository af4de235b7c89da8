"""Window-major batch assembly: host-side numpy, fixed shapes, zero python
loops per item.

Copy of rag_snvbert_tpu/data/pipeline.py (:36-297).  The multi-host branch
of ``epoch_batches`` (``n_hosts > 1``) yields each data-parallel rank its
rows of every global batch (``parallel/multihost.py``).

The reference assembles items one (sample, window) pair at a time in
DataLoader workers (TrainDataset.__getitem__, src/dataset/dataset.py:
455-582) and groups them by window with WindowGroupedSampler
(src/dataset/sampler.py:18-135) so its single-slot GPU index cache hits.
Here window-major is the *batch layout itself*: one window per batch, all
samples vectorized, which keeps every shape static and makes the
per-window retrieval context a natural carry between steps.

Reference-panel handling mirrors EmbeddingRAGDataset._load_ref_data_to_memory
(src/dataset/embedding_rag_dataset.py:79-208): strict searchsorted position
intersection per window, global-AF lookup, complete-token storage; the
per-epoch AF-guided masks are pure functions of (seed, window, level, af)
(data/masking.py) instead of mutable dataset state.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..io.freq import AF, FreqTable
from ..io.panel import PanelData
from ..io.vcf import VCFData
from ..io.vocab import MAX_SEQ_LEN, Vocab
from . import masking
from .tokenize import (genotype_label, position_normalize, sequence_padding,
                       tokenize)


@dataclasses.dataclass
class WindowMeta:
    """Static per-window info computed once at dataset build."""

    window_idx: int
    site_slice: slice          # into the training VCF's site axis
    valid_idx: np.ndarray      # indices within the slice kept after ref
                               # intersection (all if no filtering)
    ref_rows: np.ndarray       # matching row indices into the ref panel VCF
    positions: np.ndarray      # [n_valid] genomic positions
    n_sites: int


class WindowDataset:
    """Host-side dataset over (window, samples) with window-major batching.

    Produces fixed-shape numpy batches consumable directly by the train
    step.  Per-sample population features come from the FreqTable;
    masks are AF-guided curriculum masks; curriculum level is an argument,
    not hidden state.
    """

    def __init__(self, vcf: VCFData, panel: PanelData, freq: FreqTable,
                 window_info: np.ndarray, vocab: Vocab,
                 ref_vcf: VCFData | None = None,
                 seq_len: int = MAX_SEQ_LEN):
        if vcf.n_samples != panel.n_samples:
            raise ValueError(f"panel has {panel.n_samples} samples, VCF "
                             f"{vcf.n_samples}")
        self.vcf = vcf
        self.panel = panel
        self.freq = freq
        self.vocab = vocab
        self.seq_len = seq_len
        self.pop_class = np.asarray(
            [panel.pop_to_class[p] for p in panel.pop_list], np.int64)
        # Static population-class count: packed batches carry feature rows
        # for ALL classes so the wire shape never depends on which
        # populations happen to be present in a given batch.
        self.n_pop_classes = len(panel.pop_to_class)
        self._feat_cache: tuple[int, np.ndarray] | None = None

        ref_pos = ref_vcf.pos if ref_vcf is not None else None
        self.ref_vcf = ref_vcf
        self.windows: list[WindowMeta] = []
        for w in range(window_info.shape[0]):
            s, e = int(window_info[w, 0]), int(window_info[w, 1])
            sl = slice(s, e)
            pos = vcf.pos[sl]
            if ref_pos is not None:
                # Strict positional intersection (searchsorted + equality
                # check, embedding_rag_dataset.py:112-138).
                found = np.searchsorted(ref_pos, pos)
                found = np.clip(found, 0, len(ref_pos) - 1)
                match = ref_pos[found] == pos
                valid = np.flatnonzero(match)
                if valid.size == 0:
                    continue  # reference skips empty windows (:131)
                ref_rows = found[match]
                pos = pos[valid]
            else:
                valid = np.arange(e - s)
                ref_rows = np.empty(0, np.int64)
            self.windows.append(WindowMeta(
                window_idx=w, site_slice=sl, valid_idx=valid,
                ref_rows=ref_rows, positions=pos, n_sites=len(pos)))

    @property
    def n_windows(self) -> int:
        return len(self.windows)

    @property
    def n_samples(self) -> int:
        return self.vcf.n_samples

    def __len__(self) -> int:
        # (sample, window) pairs, matching TrainDataset.__len__
        return self.n_samples * self.n_windows

    # ---- per-window assembly ----

    def window_af(self, meta: WindowMeta) -> np.ndarray:
        """Global AF per site (unpadded) — drives masking and retrieval."""
        return self.freq.lookup(AF, self.freq.global_idx, meta.positions)

    def window_mask(self, meta: WindowMeta, level: int,
                    seed: int) -> np.ndarray:
        """AF-guided mask in *padded* coordinates [seq_len]."""
        af = self.window_af(meta)
        raw = masking.af_guided_mask(af, level, seed, meta.window_idx)
        return sequence_padding(raw, self.seq_len)

    def window_feat_rows(self, meta: WindowMeta) -> np.ndarray:
        """Per-population frequency-feature rows [n_pop_classes, L, 4]
        (af_p, ref, het, hom) in padded coordinates.

        Batch-independent — computed once per window and cached (the
        window-major iteration order makes a one-slot cache a 100% hit
        within a window).  Always covering the full dataset-wide class
        set keeps the packed wire shape static regardless of which
        populations a particular batch's samples belong to.
        """
        if self._feat_cache is not None and \
                self._feat_cache[0] == meta.window_idx:
            return self._feat_cache[1]
        names = ("af_p", "ref", "het", "hom")
        rows = np.zeros((self.n_pop_classes, self.seq_len, 4), np.float32)
        for p in range(self.n_pop_classes):
            fr = self.freq.window_features(meta.positions, p)
            for j, nm in enumerate(names):
                rows[p, :, j] = sequence_padding(fr[nm], self.seq_len)
        self._feat_cache = (meta.window_idx, rows)
        return rows

    def make_batch(self, meta: WindowMeta, sample_ids: np.ndarray,
                   level: int, seed: int,
                   pad_to: int | None = None,
                   packed: bool = False) -> dict[str, np.ndarray]:
        """Assemble one fixed-shape batch for `sample_ids` of one window.

        If ``pad_to`` exceeds len(sample_ids) the batch is padded by
        repeating row 0 with a zeroed loss mask (static batch shapes
        without skewing metrics).

        ``packed=True`` emits the compact wire format for the
        host->device copy (train/step.expand_packed undoes it on the
        device): int8 tokens/labels/mask, window-level ``pos``/``af``
        as [L] instead of [B, L] broadcasts, and the four per-population
        frequency features as [n_pops, L, 4] rows + a [B] row-selector
        gathered on device — ~5x fewer bytes per batch.
        """
        sample_ids = np.asarray(sample_ids)
        sl, valid = meta.site_slice, meta.valid_idx
        h1 = self.vcf.gt[sl, :, 0][valid][:, sample_ids].T  # [B, n]
        h2 = self.vcf.gt[sl, :, 1][valid][:, sample_ids].T
        n = meta.n_sites
        L = self.seq_len

        mask = self.window_mask(meta, level, seed)          # [L]
        toks1 = tokenize(h1, mask, L)
        toks2 = tokenize(h2, mask, L)

        pos_n = sequence_padding(position_normalize(meta.positions), L)
        af_g = sequence_padding(self.window_af(meta), L)

        # Per-population feature rows once per WINDOW (cached, covering the
        # full static class set), then one vectorized per-sample gather (no
        # python loop over the batch).
        b = len(sample_ids)
        rows = self.window_feat_rows(meta)               # [P, L, 4] static P
        sel = self.pop_class[sample_ids]                 # [B] row per sample

        itype = np.int8 if packed else np.int32
        batch = {
            "hap_1": toks1.astype(itype),
            "hap_2": toks2.astype(itype),
            "hap_1_label": sequence_padding(h1, L).astype(itype),
            "hap_2_label": sequence_padding(h2, L).astype(itype),
            "gt_label": sequence_padding(genotype_label(h1, h2), L).astype(itype),
            "mask": np.broadcast_to(mask, (b, L)).astype(itype).copy(),
        }
        if packed:
            batch["pos"] = pos_n.astype(np.float32)          # [L]
            batch["af"] = af_g.astype(np.float32)            # [L]
            batch["feat_rows"] = rows                        # [P, L, 4]
            batch["feat_sel"] = sel.astype(np.int8)          # [B]
        else:
            feats = rows[sel]                                # [B, L, 4]
            batch.update({
                "pos": np.broadcast_to(pos_n, (b, L)).astype(np.float32).copy(),
                "af": np.broadcast_to(af_g, (b, L)).astype(np.float32).copy(),
                "af_p": feats[..., 0], "ref": feats[..., 1],
                "het": feats[..., 2], "hom": feats[..., 3],
            })
        window_level = {"pos", "af", "feat_rows"} if packed else set()
        if pad_to is not None and pad_to > b:
            padn = pad_to - b
            for k, v in batch.items():
                if k in window_level:        # no batch dim: nothing to pad
                    continue
                batch[k] = np.concatenate(
                    [v, np.repeat(v[:1], padn, axis=0)], axis=0)
            batch["mask"][b:] = 0  # padded rows contribute no loss/metrics
        return batch

    # ---- reference-panel side (for the retrieval context) ----

    def window_ref_tokens(self, meta: WindowMeta, pad_haps_to: int | None = None
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Complete (unmasked) tokenized reference haplotypes for a window.

        Returns (ref_tokens [N_pad, L] int32, ref_af [L] f32,
        valid [N_pad] bool).  N = 2 * ref_samples (both haplotypes,
        embedding_rag_dataset.py:170-190).
        """
        if self.ref_vcf is None:
            raise ValueError("dataset built without a ref panel")
        raw = self.ref_vcf.gt[meta.ref_rows]            # [n, S, 2]
        raw = raw.reshape(raw.shape[0], -1).T            # [2S, n]
        toks = tokenize(raw, None, self.seq_len).astype(np.int32)
        af = sequence_padding(self.window_af(meta), self.seq_len)
        n = toks.shape[0]
        if pad_haps_to is not None and pad_haps_to > n:
            toks = np.concatenate(
                [toks, np.zeros((pad_haps_to - n, self.seq_len), np.int32)])
        valid = np.zeros(toks.shape[0], bool)
        valid[:n] = True
        return toks, af.astype(np.float32), valid

    # ---- window-major iteration (replaces WindowGroupedSampler) ----

    def epoch_batches(self, batch_size: int, epoch: int, level: int,
                      shuffle: bool = True, seed: int | None = None,
                      sample_ids: np.ndarray | None = None,
                      host_id: int = 0, n_hosts: int = 1,
                      packed: bool = False
                      ) -> Iterator[tuple[WindowMeta, dict]]:
        """Yield (window_meta, batch) in window-major order.

        Windows are shuffled per epoch, samples shuffled within a window
        (sampler.py set_epoch semantics); the trailing partial batch is
        padded to ``batch_size``.  Mask seed = epoch for train (val passes
        its fixed seed explicitly).

        Multi-host input (``n_hosts`` > 1): every host iterates the same
        deterministic global schedule but assembles only its contiguous
        ``batch_size / n_hosts`` slice of each global batch (a data-parallel
        rank's rows, ``parallel/multihost.py``).  All hosts see the same
        number of steps (trailing batches are padded globally, padded rows
        loss-masked), so collectives never desynchronize.  ``packed`` is
        honoured on every host.
        """
        if batch_size % n_hosts:
            raise ValueError(f"batch size {batch_size} does not divide over "
                             f"{n_hosts} hosts")
        per = batch_size // n_hosts
        rng = np.random.default_rng(epoch if seed is None else seed)
        mask_seed = epoch if seed is None else seed
        win_order = rng.permutation(self.n_windows) if shuffle else \
            np.arange(self.n_windows)
        base_ids = (np.arange(self.n_samples)
                    if sample_ids is None else np.asarray(sample_ids))
        for wi in win_order:
            meta = self.windows[wi]
            ids = rng.permutation(base_ids) if shuffle else base_ids
            for i in range(0, len(ids), batch_size):
                gchunk = ids[i: i + batch_size]
                if n_hosts == 1:
                    yield meta, self.make_batch(meta, gchunk, level,
                                                mask_seed, pad_to=batch_size,
                                                packed=packed)
                    continue
                olen = len(gchunk)
                if olen < batch_size:  # the same global padding everywhere
                    gchunk = np.concatenate(
                        [gchunk, np.repeat(gchunk[:1], batch_size - olen)])
                lo = host_id * per
                batch = self.make_batch(meta, gchunk[lo: lo + per], level,
                                        mask_seed, packed=packed)
                # rows that are global padding contribute no loss/metrics
                pad_rows = np.arange(lo, lo + per) >= olen
                if pad_rows.any():
                    batch["mask"][pad_rows] = 0
                yield meta, batch
