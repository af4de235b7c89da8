"""Window-major imputation: masked-site prediction, scatter-back, NPY and
VCF output and progressive refinement, in embedding-RAG (V18), token-RAG
(V17) or no-RAG mode.

Port of rag_snvbert_tpu/infer/imputer.py.  Kept: fixed-stride (or
window-table) windows, one-window lookahead of the reference context, the
threaded query assembly, the depth-bounded pipeline of device outputs, and
persisted per-window embedding indexes (``save_window_indexes``,
``index_dir``; the same ``index_{w}.npz`` and ``manifest.json`` as the JAX
package, so either package's files serve the other).  ``mesh``
(JAX imputer.py:77-137): every rank of the process group runs the same
imputation; each device batch's rows are split over the ``data`` axis,
the model is split over a ``model`` axis above 1 (``parallel/tp.py``),
and the probabilities are gathered to every rank (rank 0 writes them), so
the result is the single-process one.

On the card without a mesh each device batch is one replay of a CUDA
graph of ``_forward`` (retrieval, the encoder, the heads and their
softmaxes), so the host issues a few calls a batch where it issued
hundreds of launches.  The graphs are ``utils.graphs.Graphs``' (a
warm-up before each capture, one static window context a signature,
launch counts that read as the eager path's), one a key: the batch's
shapes and types (rows are padded to ``batch_size``), the window
context's signature and ``rag_mode``.  A replay gives ``_forward``'s
bits: its static inputs are filled in stream order before it (``hap_1``
and ``hap_2`` every batch, the window's ``_WINDOW_CONST`` rows and
context at the window's first batch), and its outputs are copied out of
the graph's buffers behind it, before the next replay can rewrite them,
into pinned host memory, with an event: the output pipeline's drain of a
batch waits for that batch alone, while later replays run (a plain
``.cpu()`` would wait for every replay queued, and the card would idle
through each drain).

The CPU, and any mesh (gloo cannot be captured; NCCL meshes have not
been), run ``_forward`` eagerly.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..data.prefetch import prefetch_iter
from ..data.tokenize import position_normalize, sequence_padding, tokenize
from ..device import resolve_device
from ..index.flat import FlatL2Index
from ..io.freq import AF, FreqTable
from ..io.vcf import VCFData, write_imputed_vcf
from ..io.vocab import INFER_WINDOW_LEN, MAX_SEQ_LEN
from ..parallel import comm, tp
from ..parallel.mesh import DATA_AXIS, axis_group, data_sharding
from ..train.retrieval import (TokenWindowContext, WindowRefContext,
                               build_token_window_ctx, check_int8_vocab,
                               encode_window_refs, retrieve, retrieve_tokens)
from ..utils.graphs import Graphs
from ..utils.timing import span


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

    def write_vcf(self, path: str, ref_vcf: VCFData,
                  sample_names: list[str]) -> None:
        """The imputed VCF (GT/HDS/GP/DS) over ``ref_vcf``'s sites."""
        write_imputed_vcf(path, ref_vcf.chrom, self.pos, ref_vcf.ref,
                          ref_vcf.alt, sample_names, self.hap1_prob,
                          self.hap2_prob, imputed_flag=self.imputed_flag)


class Imputer:
    """Impute target samples onto the reference panel's site list.

    ``model`` is a ``BERTFoundationModel`` over ``BERTWithEmbeddingRAG``
    (``rag_mode="embedding"``, V18), ``BERTWithRAG`` (``"token"``, V17:
    the context is the window's masked reference tokens and the model
    re-encodes the retrieved segments) or ``BERT`` (``"none"``: no window
    context, the plain forward; presets ``v10_baseline``,
    ``v13_optimized``).  The model is moved to ``device`` (``None``: the
    card, raising without one; ``"cpu"`` runs off the card).  ``use_kernel=False`` searches with the
    plain version even on the card (the JAX ``use_pallas=False``).

    ``index_dir``: load the per-window embedding indexes written by
    ``save_window_indexes`` instead of encoding the reference panel per
    window (embedding mode only).  The persisted masks must match the
    target's missing sites.  The loaded context goes through the same
    search (``ops.l2_topk``) as an encoded one.

    ``mesh``: data- and tensor-parallel imputation over the process group
    (module docstring); ``batch_size`` must divide over the data axis.

    ``use_graphs`` follows from the device and the mesh: True on the card
    without a mesh (module docstring), not a setting.  Code that hooks
    into ``_forward`` and must see it run for every batch (a recorder of
    the retrieval, a test against the eager path) turns it off on its
    instance.  ``graphs.captures`` and ``graphs.replays`` count the CUDA
    graphs of ``_forward`` captured and the device batches run as their
    replays (both stay 0 while ``use_graphs`` is False).  One call at a
    time: the replays share their graph's static buffers."""

    # Per-site rows that are the same for every sample of a window: sent
    # to the device once per window as [L] and broadcast there.
    _WINDOW_CONST = ("mask", "pos", "af", "af_p", "ref", "het", "hom")

    def __init__(self, model, ref_vcf: VCFData, freq: FreqTable,
                 window_len: int = INFER_WINDOW_LEN,
                 seq_len: int = MAX_SEQ_LEN, rag_k: int = 1,
                 ref_pad_haps: int = 2048, batch_size: int = 32,
                 use_kernel: bool = True, window=None,
                 pipeline_depth: int = 8, device=None,
                 rag_mode: str = "embedding", index_dir: str | None = None,
                 mesh=None):
        if rag_mode not in ("embedding", "token", "none"):
            raise ValueError(f"unknown rag_mode {rag_mode!r}")
        if index_dir is not None and rag_mode != "embedding":
            raise ValueError("persisted indexes exist only for "
                             "embedding-space RAG (token-space indexes are "
                             "rebuilt from the tokens)")
        self.index_dir = index_dir
        self.device = resolve_device(device)
        if rag_mode == "token" and self.device.type == "cuda":
            check_int8_vocab(model)
        self.rag_mode = rag_mode
        self.model = tp.shard_model(model.to(self.device).eval(), mesh)
        self.mesh = mesh
        # this rank's rows of every device batch (all of them without a mesh)
        self.rows = data_sharding(mesh, batch_size)
        self.data_group = (axis_group(mesh, DATA_AXIS)
                           if mesh is not None else None)
        self.ref_vcf = ref_vcf
        self.freq = freq
        self.window_len = window_len
        self.seq_len = seq_len
        self.rag_k = rag_k
        self.ref_pad_haps = ref_pad_haps
        self.batch_size = batch_size
        self.use_kernel = use_kernel
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.rows_padded = 0      # device batch rows beyond the samples
        self.use_graphs = self.device.type == "cuda" and mesh is None
        self.graphs = Graphs(self.device)
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

    def _window_ctx(self, s: int, e: int, site_mask: np.ndarray,
                    w: int | None = None
                    ) -> WindowRefContext | TokenWindowContext | None:
        """Window ``w`` (sites ``s:e``)'s search context: encoded, or with
        ``index_dir`` loaded from ``index_{w}``; None without RAG."""
        if self.rag_mode == "none":
            return None
        raw = self.ref_vcf.gt[s:e]                    # [n, S, 2]
        raw = raw.reshape(raw.shape[0], -1).T          # [2S, n]
        toks = tokenize(raw, None, self.seq_len).astype(np.int32)
        n_haps = toks.shape[0]
        if self.ref_pad_haps > n_haps:
            toks = np.concatenate([toks, np.zeros(
                (self.ref_pad_haps - n_haps, self.seq_len), np.int32)])
        valid = np.zeros(toks.shape[0], bool)
        valid[:n_haps] = True
        wmask = sequence_padding(site_mask.astype(np.int32), self.seq_len)
        if self.rag_mode == "token":
            return build_token_window_ctx(self._tensor(toks),
                                          self._tensor(wmask),
                                          valid=self._tensor(valid))
        af = sequence_padding(self.freq.lookup(
            AF, self.freq.global_idx, self.ref_vcf.pos[s:e]), self.seq_len)
        if self.index_dir is not None:
            idx = FlatL2Index.load(os.path.join(self.index_dir,
                                                f"index_{w}"),
                                   device=self.device)
            n = idx.vectors.shape[0]
            return WindowRefContext(
                ref_emb_search=idx.vectors.reshape(n, self.seq_len, -1),
                ref_tokens=self._tensor(toks), ref_af=self._tensor(af),
                ref_norms=idx.norms)
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

    def _present(self, target: VCFData) -> tuple[np.ndarray, np.ndarray]:
        """``(present, rows)`` over the reference sites: whether the
        (sorted) target has the site, and its target row where it does."""
        found = np.searchsorted(target.pos, self.ref_vcf.pos)
        found = np.clip(found, 0, max(len(target.pos) - 1, 0))
        present = (target.pos[found] == self.ref_vcf.pos) if len(target.pos) \
            else np.zeros(self.ref_vcf.n_variants, bool)
        return present, found

    @torch.inference_mode()
    def save_window_indexes(self, out_dir: str, target: VCFData) -> dict:
        """Persist each window's embedding-space index for ``target``'s
        missing sites as ``out_dir/index_{w}.npz`` (``FlatL2Index.save``:
        the masked references' embeddings ``[N, L * D]`` bf16 and their
        norms, +inf on padding rows) and ``manifest.json``
        (``{"windows", "d", "seq_len"}``).  Offline parity with the
        reference's per-window FAISS files; JAX imputer.py:216-255."""
        if self.rag_mode != "embedding":
            raise ValueError("indexes are embedding-space")
        if self.index_dir is not None:
            raise ValueError("this Imputer loads persisted indexes; build "
                             "the files with an Imputer constructed without "
                             "index_dir")
        os.makedirs(out_dir, exist_ok=True)
        present, _ = self._present(self._sorted_target(target))
        manifest = {"windows": len(self.windows), "d": None,
                    "seq_len": self.seq_len}
        for w, (s, e) in enumerate(self.windows):
            ctx = self._window_ctx(s, e, ~present[s:e], w)
            n = ctx.ref_emb_search.shape[0]
            vectors = ctx.ref_emb_search.reshape(n, -1)
            FlatL2Index(vectors=vectors, norms=ctx.ref_norms).save(
                os.path.join(out_dir, f"index_{w}"))
            manifest["d"] = int(vectors.shape[1])
        with open(os.path.join(out_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        return manifest

    def _forward(self, batch: dict,
                 ctx: WindowRefContext | TokenWindowContext | None):
        b = batch["hap_1"].shape[0]
        batch = {k: (v[None, :].expand(b, v.shape[0])
                     if k in self._WINDOW_CONST and v.dim() == 1 else v)
                 for k, v in batch.items()}
        if isinstance(ctx, TokenWindowContext):
            x = retrieve_tokens(batch, ctx, self.rag_k, self.use_kernel)
        elif ctx is None:
            x = batch
        else:
            x = retrieve(self._embed, batch, ctx, self.rag_k,
                         self.use_kernel)
        out = self.model(x)
        p1 = torch.softmax(out[0].float(), dim=-1)[..., 1]
        p2 = torch.softmax(out[1].float(), dim=-1)[..., 1]
        pgt = torch.softmax(out[2].float(), dim=-1)
        return p1, p2, pgt

    def _graph_forward(self, batch: dict, ctx, new_window: bool):
        """``_forward(batch, ctx)`` as a replay of its key's graph,
        captured at the key's first batch; ``new_window``: the batch is
        its window's first (the window rows are loaded).  Returns the
        outputs copied (pinned, in stream order) to the host and the event
        after the copies: the replay, the copies and the event are all on
        this imputer's card's current stream, whichever card is the
        current device."""
        sig, static_ctx = self.graphs.context(ctx)
        key = (tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(batch.items())), sig, self.rag_mode)
        g = self.graphs.by_key.get(key)
        if g is None:
            static = {k: v.clone() for k, v in batch.items()}
            g = self.graphs.capture(
                key, "imputer.capture",
                lambda: self._forward(static, static_ctx), static)
        else:
            for k, v in batch.items():
                if new_window or k not in self._WINDOW_CONST:
                    g.inputs[k].copy_(v)
        self.graphs.replay(g)
        out = tuple(t.to("cpu", non_blocking=True, copy=True) for t in g.out)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return out, ready

    @torch.inference_mode()
    def impute(self, target: VCFData, pop: int | None = None
               ) -> ImputationResult:
        """Impute all target samples over the whole reference site list.

        ``pop``: population class for the af_p/ref/het/hom features
        (defaults to the global pool).

        Spans (``utils/timing.py``): ``imputer.call`` around all of it,
        ``imputer.window_context`` around each context built,
        ``imputer.assembly_wait`` around each wait on the assembly thread,
        ``imputer.launch`` around each device batch's copies and enqueue
        (its replay on the card, and ``imputer.capture`` inside it around
        a graph's capture), ``imputer.drain`` around each batch's fetch
        and scatter."""
        with span("imputer.call"):
            return self._impute(target, pop)

    def _impute(self, target: VCFData, pop: int | None) -> ImputationResult:
        target = self._sorted_target(target)
        n_sites = self.ref_vcf.n_variants
        n_samp = target.n_samples
        hap1 = np.zeros((n_sites, n_samp), np.float32)
        hap2 = np.zeros((n_sites, n_samp), np.float32)
        gtp = np.zeros((n_sites, n_samp, 4), np.float32)

        # position_needed: ref-panel sites missing from the target VCF
        present, target_rows = self._present(target)

        pop_idx = self.freq.global_idx if pop is None else pop
        L = self.seq_len
        bs = self.batch_size

        def make_ctx(w):
            s, e = self.windows[w]
            with span("imputer.window_context"):
                return self._window_ctx(s, e, ~present[s:e], w)

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
            (assemble(w) for w in range(len(self.windows))), size=1,
            wait_span="imputer.assembly_wait")
        next_ctx = make_ctx(0) if self.windows else None
        for w, (s, e) in enumerate(self.windows):
            n = e - s
            ctx = next_ctx
            toks1, toks2, mask_p, row, pos_n, af_g = next(assembled)
            const = {"mask": mask_p, "pos": pos_n, "af": af_g,
                     "af_p": row["af_p"], "ref": row["ref"],
                     "het": row["het"], "hom": row["hom"]}
            const = {k: self._tensor(v) for k, v in const.items()}

            def scatter(b0, b1, nb, out, ready):
                with span("imputer.drain"):
                    if ready is not None:      # a replay's host copies
                        ready.synchronize()
                    if self.data_group is not None:   # every data rank's
                        out = (comm.all_gather(t, self.data_group)
                               .flatten(0, 1) for t in out)
                    p1, p2, pg = (t.cpu().numpy() for t in out)
                    # strip SOS slot and padding: body = sites s..e at 1..n
                    hap1[s:e, b0:b1] = p1[:nb, 1: 1 + n].T
                    hap2[s:e, b0:b1] = p2[:nb, 1: 1 + n].T
                    gtp[s:e, b0:b1] = pg[:nb, 1: 1 + n].transpose(1, 0, 2)

            # Outputs are fetched a few batches behind the launches: the
            # depth bound caps the outputs held (on the device, or in pinned
            # host memory behind a replay) at O(depth) batches.
            pending = []
            for b0 in range(0, n_samp, bs):
                b1 = min(b0 + bs, n_samp)
                nb = b1 - b0
                pad = bs - nb
                self.rows_padded += pad

                def pad_rows(x):
                    return np.concatenate([x, np.repeat(x[:1], pad, 0)]) \
                        if pad else x

                mine = self.rows
                with span("imputer.launch"):
                    batch = {"hap_1": self._tensor(
                                 pad_rows(toks1[b0:b1])[mine]),
                             "hap_2": self._tensor(
                                 pad_rows(toks2[b0:b1])[mine]), **const}
                    out = (self._graph_forward(batch, ctx, b0 == 0)
                           if self.use_graphs
                           else (self._forward(batch, ctx), None))
                    pending.append((b0, b1, nb, *out))
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
