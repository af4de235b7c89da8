"""Window-major imputation: masked-site prediction, scatter-back, NPY output
and progressive refinement, in embedding-RAG mode (V18).

Port of rag_snvbert_tpu/infer/imputer.py.  Kept: fixed-stride (or
window-table) windows, one-window lookahead of the reference context, the
threaded query assembly, and the depth-bounded pipeline of device outputs.
Not ported yet: token and no-RAG modes, persisted indexes (``index_dir``),
the device mesh, and VCF writing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.prefetch import prefetch_iter
from ..data.tokenize import position_normalize, sequence_padding, tokenize
from ..device import resolve_device
from ..io.freq import AF, FreqTable
from ..io.vcf import VCFData
from ..io.vocab import INFER_WINDOW_LEN, MAX_SEQ_LEN
from ..train.retrieval import WindowRefContext, encode_window_refs, retrieve


@dataclasses.dataclass
class ImputationResult:
    """[n_sites, n_samples] probability matrices + site metadata."""

    hap1_prob: np.ndarray   # P(allele==1) haplotype 1
    hap2_prob: np.ndarray
    gt_prob: np.ndarray     # [n_sites, n_samples, 4]
    pos: np.ndarray
    imputed_flag: np.ndarray  # True where the site was missing in the target

    def save_npy(self, prefix: str) -> None:
        np.save(prefix + ".HAP1.npy", self.hap1_prob)
        np.save(prefix + ".HAP2.npy", self.hap2_prob)
        np.save(prefix + ".GT.npy", self.gt_prob)
        np.save(prefix + ".POS.npy", self.pos)
        np.save(prefix + ".POS_Flag.npy", self.imputed_flag)


class Imputer:
    """Impute target samples onto the reference panel's site list.

    ``model`` is a ``BERTFoundationModel`` over ``BERTWithEmbeddingRAG``;
    it is moved to ``device`` (``None``: the card, raising without one;
    ``"cpu"`` runs off the card).  ``use_kernel=False`` searches with the
    plain version even on the card (the JAX ``use_pallas=False``)."""

    # Per-site rows that are the same for every sample of a window: sent
    # to the device once per window as [L] and broadcast there.
    _WINDOW_CONST = ("mask", "pos", "af", "af_p", "ref", "het", "hom")

    def __init__(self, model, ref_vcf: VCFData, freq: FreqTable,
                 window_len: int = INFER_WINDOW_LEN,
                 seq_len: int = MAX_SEQ_LEN, rag_k: int = 1,
                 ref_pad_haps: int = 2048, batch_size: int = 32,
                 use_kernel: bool = True, window=None,
                 pipeline_depth: int = 8, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.ref_vcf = ref_vcf
        self.freq = freq
        self.window_len = window_len
        self.seq_len = seq_len
        self.rag_k = rag_k
        self.ref_pad_haps = ref_pad_haps
        self.batch_size = batch_size
        self.use_kernel = use_kernel
        self.pipeline_depth = max(int(pipeline_depth), 1)
        n = ref_vcf.n_variants
        if window is not None:
            self.windows = [(int(s), int(min(e, n)))
                            for s, e in window.window_info]
        else:
            self.windows = [(int(s), int(min(s + window_len, n)))
                            for s in np.arange(0, n, window_len)]

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(self.device, non_blocking=True)

    def _embed(self, tokens: torch.Tensor, af: torch.Tensor) -> torch.Tensor:
        return self.model.embed(tokens, af)

    def _window_ctx(self, s: int, e: int,
                    site_mask: np.ndarray) -> WindowRefContext:
        raw = self.ref_vcf.gt[s:e]                    # [n, S, 2]
        raw = raw.reshape(raw.shape[0], -1).T          # [2S, n]
        toks = tokenize(raw, None, self.seq_len).astype(np.int32)
        n_haps = toks.shape[0]
        if self.ref_pad_haps > n_haps:
            toks = np.concatenate([toks, np.zeros(
                (self.ref_pad_haps - n_haps, self.seq_len), np.int32)])
        valid = np.zeros(toks.shape[0], bool)
        valid[:n_haps] = True
        af = sequence_padding(self.freq.lookup(
            AF, self.freq.global_idx, self.ref_vcf.pos[s:e]), self.seq_len)
        wmask = sequence_padding(site_mask.astype(np.int32), self.seq_len)
        return encode_window_refs(self._embed, self._tensor(toks),
                                  self._tensor(af), self._tensor(wmask),
                                  valid=self._tensor(valid))

    @staticmethod
    def _sorted_target(target: VCFData) -> VCFData:
        """Normalize an untrusted target to sorted positions (every
        present/missing computation below uses searchsorted)."""
        if len(target.pos) and np.any(np.diff(target.pos) < 0):
            order = np.argsort(target.pos, kind="stable")
            target = dataclasses.replace(
                target, pos=target.pos[order], gt=target.gt[order],
                chrom=target.chrom[order], ref=target.ref[order],
                alt=target.alt[order], ids=target.ids[order])
        return target

    def _forward(self, batch: dict, ctx: WindowRefContext):
        b = batch["hap_1"].shape[0]
        batch = {k: (v[None, :].expand(b, v.shape[0])
                     if k in self._WINDOW_CONST and v.dim() == 1 else v)
                 for k, v in batch.items()}
        x = retrieve(self._embed, batch, ctx, self.rag_k, self.use_kernel)
        out = self.model(x)
        p1 = torch.softmax(out[0].float(), dim=-1)[..., 1]
        p2 = torch.softmax(out[1].float(), dim=-1)[..., 1]
        pgt = torch.softmax(out[2].float(), dim=-1)
        return p1, p2, pgt

    @torch.inference_mode()
    def impute(self, target: VCFData, pop: int | None = None
               ) -> ImputationResult:
        """Impute all target samples over the whole reference site list.

        ``pop``: population class for the af_p/ref/het/hom features
        (defaults to the global pool)."""
        target = self._sorted_target(target)
        n_sites = self.ref_vcf.n_variants
        n_samp = target.n_samples
        hap1 = np.zeros((n_sites, n_samp), np.float32)
        hap2 = np.zeros((n_sites, n_samp), np.float32)
        gtp = np.zeros((n_sites, n_samp, 4), np.float32)

        # position_needed: ref-panel sites missing from the target VCF
        found = np.searchsorted(target.pos, self.ref_vcf.pos)
        found = np.clip(found, 0, max(len(target.pos) - 1, 0))
        present = (target.pos[found] == self.ref_vcf.pos) if len(target.pos) \
            else np.zeros(n_sites, bool)
        target_rows = found  # valid where present

        pop_idx = self.freq.global_idx if pop is None else pop
        L = self.seq_len
        bs = self.batch_size

        def make_ctx(w):
            s, e = self.windows[w]
            return self._window_ctx(s, e, ~present[s:e])

        def assemble(w):
            """Host-side query assembly for one window (pure numpy):
            known alleles where present, 0 elsewhere."""
            s, e = self.windows[w]
            miss = ~present[s:e]
            if len(target.pos):
                rows = np.minimum(target_rows[s:e], len(target.pos) - 1)
                g1, g2 = target.gt[rows, :, 0], target.gt[rows, :, 1]
            else:
                g1 = g2 = np.zeros((e - s, n_samp), np.int8)
            h1 = np.where(present[s:e][:, None], g1, 0).T.astype(np.int8)
            h2 = np.where(present[s:e][:, None], g2, 0).T.astype(np.int8)
            mask_p = sequence_padding(miss.astype(np.int32), L)
            toks1 = tokenize(h1, mask_p, L).astype(np.int32)
            toks2 = tokenize(h2, mask_p, L).astype(np.int32)
            positions = self.ref_vcf.pos[s:e]
            feats = self.freq.window_features(positions, pop_idx)
            row = {k: sequence_padding(v, L) for k, v in feats.items()}
            pos_n = sequence_padding(position_normalize(positions), L)
            af_g = sequence_padding(self.freq.lookup(
                AF, self.freq.global_idx, positions), L)
            return toks1, toks2, mask_p, row, pos_n, af_g

        # One-window context lookahead + threaded query assembly: the next
        # window's reference encode is queued on the device behind this
        # window's forwards, before their outputs are fetched, while a
        # daemon thread assembles the next window's numpy queries.
        assembled = prefetch_iter(
            (assemble(w) for w in range(len(self.windows))), size=1)
        next_ctx = make_ctx(0) if self.windows else None
        for w, (s, e) in enumerate(self.windows):
            n = e - s
            ctx = next_ctx
            toks1, toks2, mask_p, row, pos_n, af_g = next(assembled)
            const = {"mask": mask_p, "pos": pos_n, "af": af_g,
                     "af_p": row["af_p"], "ref": row["ref"],
                     "het": row["het"], "hom": row["hom"]}
            const = {k: self._tensor(v) for k, v in const.items()}

            def scatter(b0, b1, nb, out):
                p1, p2, pg = (t.cpu().numpy() for t in out)
                # strip SOS slot and padding: body = sites s..e at 1..n
                hap1[s:e, b0:b1] = p1[:nb, 1: 1 + n].T
                hap2[s:e, b0:b1] = p2[:nb, 1: 1 + n].T
                gtp[s:e, b0:b1] = pg[:nb, 1: 1 + n].transpose(1, 0, 2)

            # Outputs are fetched a few batches behind the launches: the
            # depth bound caps device-resident outputs at O(depth) batches.
            pending = []
            for b0 in range(0, n_samp, bs):
                b1 = min(b0 + bs, n_samp)
                nb = b1 - b0
                pad = bs - nb

                def pad_rows(x):
                    return np.concatenate([x, np.repeat(x[:1], pad, 0)]) \
                        if pad else x

                haps = {"hap_1": self._tensor(pad_rows(toks1[b0:b1])),
                        "hap_2": self._tensor(pad_rows(toks2[b0:b1]))}
                pending.append((b0, b1, nb,
                                self._forward({**haps, **const}, ctx)))
                if len(pending) > self.pipeline_depth:
                    scatter(*pending.pop(0))
            if w + 1 < len(self.windows):
                next_ctx = make_ctx(w + 1)
            for item in pending:
                scatter(*item)

        # Known sites keep their observed alleles (probability 0/1), and
        # the genotype matrix follows.
        known = present
        if len(target.pos):
            kr = np.minimum(target_rows, len(target.pos) - 1)
            obs1 = target.gt[kr, :, 0].astype(np.float32)
            obs2 = target.gt[kr, :, 1].astype(np.float32)
            hap1[known] = obs1[known]
            hap2[known] = obs2[known]
            o1, o2 = obs1[known], obs2[known]
            # class order (h1<<1)+h2: p00, p01, p10, p11
            gtp[known] = np.stack([(1 - o1) * (1 - o2), (1 - o1) * o2,
                                   o1 * (1 - o2), o1 * o2], axis=-1)
        return ImputationResult(hap1_prob=hap1, hap2_prob=hap2, gt_prob=gtp,
                                pos=self.ref_vcf.pos.copy(),
                                imputed_flag=~present)

    def impute_progressive(self, target: VCFData, rounds: int = 3,
                           fill_fraction: float = 0.5) -> ImputationResult:
        """Iterative refinement: each round imputes, then the most
        confident ``fill_fraction`` of still-missing sites become observed
        input for the next round."""
        work = dataclasses.replace(target, gt=target.gt.copy(),
                                   pos=target.pos.copy())
        result = None
        originally_missing = None
        for r in range(rounds):
            result = self.impute(work)
            if originally_missing is None:
                originally_missing = result.imputed_flag.copy()
            missing = result.imputed_flag
            if not missing.any() or r == rounds - 1:
                break
            # confidence = mean over samples of both haps' distance from 0.5
            conf = (np.abs(result.hap1_prob - 0.5)
                    + np.abs(result.hap2_prob - 0.5)).mean(axis=1)
            miss_idx = np.flatnonzero(missing)
            order = miss_idx[np.argsort(-conf[miss_idx])]
            fill = order[: max(1, int(len(order) * fill_fraction))]
            calls1 = (result.hap1_prob[fill] >= 0.5).astype(np.int8)
            calls2 = (result.hap2_prob[fill] >= 0.5).astype(np.int8)
            gt_new = np.stack([calls1, calls2], axis=-1)  # [F, S, 2]
            merged_pos = np.concatenate([work.pos, self.ref_vcf.pos[fill]])
            merged_gt = np.concatenate([work.gt, gt_new], axis=0)
            order2 = np.argsort(merged_pos, kind="stable")
            work = dataclasses.replace(work, pos=merged_pos[order2],
                                       gt=merged_gt[order2])
        result.imputed_flag = originally_missing
        return result
