"""Training orchestration: epochs, curriculum, validation, early stopping,
metrics CSV, checkpointing.

Port of rag_snvbert_tpu/train/trainer.py (:41-645).  Reference parity
(behavioural):
  - epoch loop with per-epoch mask regeneration (seed = epoch) and
    retrieval-context invalidation (src/train_embedding_rag.py:343-434);
  - curriculum add_level every 2 epochs, capped (=level 5 -> 80%)
    (:415-431; data/masking.MASK_RATES);
  - validation at a fixed level/seed (:274-291 — level 4, seed 2024);
  - early stopping on val F1 with patience + min_delta
    (pretrain_with_val_optimized.py:490-522);
  - per-epoch metrics CSV (append mode, :424-481) + jsonl event log;
  - checkpoints every epoch + best (:524-552): ``ckpt_ep{N}/state.pt``
    (``torch.save``) with the parameters, the whole optimizer state (the
    accumulation buffers included), step, epoch, curriculum level and the
    early-stop fields.  The retrieval context is derived state and is not
    checkpointed (train_embedding_rag.py:378-387).  With
    ``async_checkpoints`` (the default, as in the JAX trainer, :491-520)
    the file is written on a background thread while training goes on,
    and ``finalize()`` (called at the end of ``fit``) waits for it;
  - ``init_params_from``: a warm start from another run's or a converted
    reference checkpoint's weights, with a fresh optimizer;
  - ``profile_dir``: a ``torch.profiler`` Chrome trace of ``profile_steps``
    steady micro-steps of the first epoch trained (JAX trainer.py:418-433);
  - ``steps_per_dispatch`` K > 1 (JAX trainer.py:150-171, 362-400):
    consecutive same-window training batches go in chunks of up to K
    (``_chunk_batches``), each chunk one dispatch (``train/dispatch.py``:
    one CUDA graph replay on the card) with the semantics of K single
    steps; ``step``, ``n_batches``, the step marks, ``log_freq`` and the
    profiler window advance by the chunk, as in JAX.  Validation stays
    per step.

The trainer runs wherever the model's parameters are (``build_model`` puts
them on the card unless given ``device="cpu"``).  Batches are assembled on
a host thread (``data/prefetch.py``) and copied to the card from pinned
memory on that thread; the epoch's metric counters stay on the device and
reach the host once per epoch.

``mesh`` (``parallel.make_mesh``; JAX trainer.py:79-87, 191-263, 303-308,
384-412, 553-563): every rank of the process group runs the same trainer.
Each data rank assembles its rows of every global batch
(``epoch_batches(host_id=, n_hosts=)``); gradients, losses and counters
are summed over the data group, so the metrics, early stopping and the
updates are the single-process run's on every rank.  An ``index`` axis
above 1 shards the window context (``shard_ctx="auto"``,
``train/sharded_retrieval.py``), merged by ``ctx_merge``; a ``model`` axis
above 1 splits the encoder (``parallel/tp.py``).  Only rank 0 writes the
CSV, the event log and the checkpoints, which hold full tensors: a
checkpoint saved under tensor parallelism restores on one device and the
other way round.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..data import masking
from ..data.pipeline import WindowDataset
from ..data.prefetch import prefetch_iter
from ..models.layers import BatchRows
from ..parallel import tp
from ..parallel.mesh import (DATA_AXIS, INDEX_AXIS, MODEL_AXIS, axis_group,
                             axis_rank, axis_size, is_writer)
from ..utils.timing import span, start_trace, stop_trace
from . import metrics as metrics_lib
from .retrieval import (build_token_window_ctx, check_int8_vocab,
                        encode_window_refs)
from .dispatch import ChunkRunner, epoch_accumulator
from .schedule import make_optimizer
from .sharded_retrieval import encode_window_refs_sharded
from .step import StepConfig, eval_step, step_generator, train_step


@dataclasses.dataclass
class TrainerConfig:
    """The JAX package's fields, so one config means one run in both.
    ``rng_impl`` has no effect in the port (dropout draws come from a torch
    generator per step).  ``steps_per_dispatch`` K > 1 runs each chunk of
    up to K same-window training micro-steps as one dispatch: one CUDA
    graph replay on the card (``train/dispatch.py``), with the semantics
    of K single steps."""

    epochs: int = 20
    batch_size: int = 24
    val_batch_size: int = 48
    init_lr: float = 1e-5
    max_lr: float = 7.5e-5
    warmup_steps: int = 15000
    grad_accum_steps: int = 1
    focal_gamma: float = 2.0
    use_recon_loss: bool = False
    rag_k: int = 1
    rare_threshold: float = 0.05
    curriculum_every: int = 2          # add_level every N epochs
    max_level: int = masking.MAX_LEVEL
    val_level: int = masking.VAL_LEVEL
    val_seed: int = masking.VAL_SEED
    patience: int = 5
    min_delta: float = 0.001
    val_metric: str = "hap_f1"
    ref_pad_haps: int = 2048           # static panel-size pad per window
    rag_mode: str = "embedding"        # "embedding" (V18) | "token" (V17) | "none"
    output_dir: str = "runs/default"
    log_freq: int = 100
    seed: int = 42
    rng_impl: str = "rbg"              # no effect here
    # Build the next window's retrieval context while the current window is
    # still training; costs a second resident context (1.6 GB at flagship
    # scale).  Staleness when on: params up to one window older.
    prefetch_ctx: bool = False
    # Shard the window context over the mesh's ``index`` axis
    # (train/sharded_retrieval.py); "auto": when that axis is above 1.
    shard_ctx: bool | str = "auto"
    # The sharded context's candidate merge: "all_gather" | "ring".
    ctx_merge: str = "all_gather"
    # Host-side batch prefetch depth (data/prefetch.py); 0 assembles and
    # copies each batch on the training thread.
    prefetch_batches: int = 2
    # "level" = the discrete curriculum; "cosine" | "linear" |
    # "exponential" = the continuous AdaptiveMaskScheduler ramp
    # (masking.adaptive_mask_ratio).  Validation always uses val_level.
    mask_schedule: str = "level"
    mask_start: float = 0.15
    mask_end: float = 0.8
    # Record a host timestamp after every step into Trainer.step_marks.
    record_step_times: bool = False
    # Training micro-steps a dispatch: chunks of up to K same-window
    # batches, each one CUDA graph replay on the card (train/dispatch.py).
    steps_per_dispatch: int = 1
    # Write each checkpoint on a background thread, overlapping the next
    # epoch's steps (Trainer.save_checkpoint); False writes it in place.
    async_checkpoints: bool = True
    keep_checkpoints: int = 3          # newest N epoch dirs (+ best); 0 all
    # torch.profiler capture: a Chrome trace (host operations and, on the
    # card, kernels) of ``profile_steps`` steady micro-steps after the first
    # of the first epoch trained, written under ``profile_dir``
    # (tools/summarize_trace.py reads it).
    profile_dir: str | None = None
    profile_steps: int = 4


@dataclasses.dataclass
class EarlyStopping:
    """Best-metric tracker with patience (pretrain_with_val_optimized.py:
    490-522)."""

    patience: int
    min_delta: float
    best: float = -np.inf
    best_epoch: int = -1
    bad_epochs: int = 0

    def update(self, value: float, epoch: int) -> tuple[bool, bool]:
        """Returns (is_best, should_stop)."""
        if value > self.best + self.min_delta:
            self.best, self.best_epoch, self.bad_epochs = value, epoch, 0
            return True, False
        self.bad_epochs += 1
        return False, self.bad_epochs >= self.patience


def _chunk_batches(it, k: int):
    """Group consecutive same-window (meta, batch) pairs into stacked
    ``[n, ...]`` chunks of at most ``k`` for one dispatch each (JAX
    trainer.py:150-171).  Chunks never span a window boundary (a chunk
    shares one retrieval context); a window's trailing chunk may be
    shorter (one more graph).  Packed batches keep one ``feat_rows`` shape
    across a cohort, so they stack."""
    pending: list = []
    cur_meta = None

    def flush():
        stacked = {key: np.stack([b[key] for b in pending])
                   for key in pending[0]}
        return cur_meta, stacked

    for meta, b in it:
        if pending and (meta.window_idx != cur_meta.window_idx
                        or len(pending) == k):
            yield flush()
            pending = []
        cur_meta = meta
        pending.append(b)
    if pending:
        yield flush()


def _with_lookahead(it):
    """Yield (meta, batch, next_meta) with one-step lookahead over
    (meta, batch) pairs; next_meta is None on the last batch."""
    prev = None
    for meta, batch in it:
        if prev is not None:
            yield prev[0], prev[1], meta
        prev = (meta, batch)
    if prev is not None:
        yield prev[0], prev[1], None


def _host_copy(tree):
    """A copy of a checkpoint payload with every tensor copied to the host
    (new storage even for a CPU tensor), so that no later in-place update
    of a parameter or an Adam moment reaches it."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _to_host(tree: dict) -> dict:
    """Copy a dict tree of device tensors to numpy in one transfer."""
    leaves: list[torch.Tensor] = []

    def collect(t):
        for v in t.values():
            collect(v) if isinstance(v, dict) else leaves.append(v)

    collect(tree)
    flat = torch.cat([x.reshape(-1).double() for x in leaves]).cpu().numpy()
    pos = 0

    def rebuild(t):
        nonlocal pos
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = rebuild(v)
            else:
                out[k] = flat[pos: pos + v.numel()].reshape(v.shape)
                pos += v.numel()
        return out

    return rebuild(tree)


class Trainer:
    """Window-major RAG trainer.

    ``model`` comes with its weights (``config.build_model``, then
    ``interop.load_flax_params`` to start from flax ones).
    ``train_sample_ids``/``val_sample_ids``: optional sample-index subsets
    (the single-cohort train/val workflow of the reference,
    scripts/split_data.py:14-261): with ``val_sample_ids`` and no separate
    ``val_ds``, validation runs on ``train_ds`` restricted to them.
    """

    def __init__(self, model, train_ds: WindowDataset, cfg: TrainerConfig,
                 val_ds: WindowDataset | None = None, mesh=None,
                 train_sample_ids=None, val_sample_ids=None):
        if cfg.rag_mode not in ("embedding", "token", "none"):
            raise ValueError(f"unknown rag_mode {cfg.rag_mode!r}")
        if cfg.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{cfg.steps_per_dispatch}")
        self.mesh = mesh
        self.n_data = axis_size(mesh, DATA_AXIS)
        self.data_rank = axis_rank(mesh, DATA_AXIS)
        self.data_group = (axis_group(mesh, DATA_AXIS) if mesh is not None
                           else None)
        for bs in (cfg.batch_size, cfg.val_batch_size):
            if bs % self.n_data:
                raise ValueError(f"batch size {bs} does not divide over the "
                                 f"{self.n_data} data ranks")
        self.shard_ctx = (cfg.shard_ctx if isinstance(cfg.shard_ctx, bool)
                          else axis_size(mesh, INDEX_AXIS) > 1)
        if self.shard_ctx and mesh is None:
            raise ValueError("shard_ctx requires a mesh with an 'index' axis")
        self.writer = is_writer()
        self.model = tp.shard_model(model, mesh)
        self.device = next(model.parameters()).device
        if cfg.rag_mode == "token" and self.device.type == "cuda":
            check_int8_vocab(model)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.train_sample_ids = (None if train_sample_ids is None
                                 else np.asarray(train_sample_ids))
        self.val_sample_ids = (None if val_sample_ids is None
                               else np.asarray(val_sample_ids))
        self.cfg = cfg
        self.level = 0
        self.step = 0                      # micro-steps taken (JAX state.step)
        self.step_marks: list | None = None  # see record_step_times
        self.trace_path: str | None = None   # see profile_dir
        self.start_epoch = 0
        self.stopper = EarlyStopping(cfg.patience, cfg.min_delta)
        self.step_cfg = StepConfig(
            focal_gamma=cfg.focal_gamma, use_recon=cfg.use_recon_loss,
            rag_k=cfg.rag_k, rare_threshold=cfg.rare_threshold,
            ctx_merge=cfg.ctx_merge)
        self.optimizer = make_optimizer(model, cfg.init_lr, cfg.max_lr,
                                        cfg.warmup_steps,
                                        accum_steps=cfg.grad_accum_steps)
        if axis_size(mesh, MODEL_AXIS) > 1:
            self.optimizer.set_tensor_parallel(axis_group(mesh, MODEL_AXIS),
                                               tp.sharded_flags(model))
        self.runner = (ChunkRunner(self.model, self.optimizer, self.step_cfg,
                                   cfg.seed, self.data_group,
                                   self._batch_rows(cfg.batch_size), mesh)
                       if cfg.steps_per_dispatch > 1 else None)
        self._saver: threading.Thread | None = None  # see save_checkpoint
        self._save_error: BaseException | None = None
        os.makedirs(cfg.output_dir, exist_ok=True)
        self.csv_path = os.path.join(cfg.output_dir, "metrics.csv")
        self.log_path = os.path.join(cfg.output_dir, "events.jsonl")

    def _put_batch(self, batch: dict) -> dict:
        """Host batch -> device tensors (pinned-memory copies on the card;
        they may be issued from the prefetch thread)."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v).to(self.device)
                    for k, v in batch.items()}
        return {k: torch.from_numpy(v).pin_memory().to(self.device,
                                                        non_blocking=True)
                for k, v in batch.items()}

    def _batch_rows(self, bs: int) -> BatchRows | None:
        """This data rank's rows of a global batch of ``bs`` (dropout)."""
        if self.mesh is None:
            return None
        per = bs // self.n_data
        return BatchRows.stacked(self.data_rank * per, per, bs,
                                 self.cfg.rag_k,
                                 token_rag=self.cfg.rag_mode == "token")

    # ---- retrieval context (the per-window index, derived state) ----

    def _window_ctx(self, ds: WindowDataset, meta, level, seed: int):
        """Token mode: the window's masked reference tokens and their norms
        (JAX trainer.py:299-302).  Embedding mode: embed the masked
        reference haplotypes with the embedding in eval mode and no
        gradient (retrieval.py:150-161 of the JAX package), whatever mode
        the model is in."""
        toks, af, valid = ds.window_ref_tokens(
            meta, pad_haps_to=self.cfg.ref_pad_haps)
        wmask = ds.window_mask(meta, level, seed)
        dev = self.device
        if self.cfg.rag_mode == "token":
            return build_token_window_ctx(
                torch.from_numpy(toks).to(dev).long(),
                torch.from_numpy(wmask).to(dev),
                valid=torch.from_numpy(valid).to(dev))
        was_training = self.model.training
        self.model.eval()
        args = (self.model.embed, torch.from_numpy(toks).to(dev).long(),
                torch.from_numpy(af).to(dev), torch.from_numpy(wmask).to(dev))
        try:
            if self.shard_ctx:
                return encode_window_refs_sharded(
                    *args, self.mesh, valid=torch.from_numpy(valid).to(dev))
            return encode_window_refs(*args,
                                      valid=torch.from_numpy(valid).to(dev))
        finally:
            self.model.train(was_training)

    # ---- epoch loops ----

    @property
    def has_validation(self) -> bool:
        return self.val_ds is not None or self.val_sample_ids is not None

    def _run_epoch(self, epoch: int, train: bool) -> dict:
        """One epoch (``train`` or validation); returns its summary.  Its
        spans: ``trainer.epoch`` around all of it, ``trainer.window_context``
        around each context built, ``trainer.batch_wait`` around each wait
        on the prefetch queue, ``dispatch.chunk`` around each training
        dispatch (``utils/timing.py``)."""
        with span("trainer.epoch"):
            return self._epoch(epoch, train)

    def _epoch(self, epoch: int, train: bool) -> dict:
        cfg = self.cfg
        ds = self.train_ds if train else (self.val_ds or self.train_ds)
        sample_ids = self.train_sample_ids if train else self.val_sample_ids
        level = self.level if train else cfg.val_level
        if train and cfg.mask_schedule != "level":
            level = masking.adaptive_mask_ratio(
                epoch, cfg.epochs, start=cfg.mask_start, end=cfg.mask_end,
                schedule=cfg.mask_schedule)
        seed = epoch if train else cfg.val_seed
        bs = cfg.batch_size if train else cfg.val_batch_size
        k_chunk = cfg.steps_per_dispatch if train else 1
        # Counters and loss totals stay on the device across the epoch
        # (the chunk runner's own accumulator: its graphs add into it).
        acc = (self.runner.zero_acc() if k_chunk > 1
               else epoch_accumulator(self.device))
        n_batches = 0
        t0 = time.time()
        self.step_marks = [] if cfg.record_step_times else None
        want_prof = bool(train and cfg.profile_dir and self.writer
                         and epoch == self.start_epoch)
        prof = None
        prof_start_n = 0
        current_wid = -1
        ctx = None
        prefetched: dict[int, Any] = {}
        use_rag = ds.ref_vcf is not None and cfg.rag_mode != "none"
        batch_iter = ds.epoch_batches(bs, epoch, level, shuffle=train,
                                      seed=seed, sample_ids=sample_ids,
                                      host_id=self.data_rank,
                                      n_hosts=self.n_data, packed=True)
        if k_chunk > 1:
            batch_iter = _chunk_batches(batch_iter, k_chunk)
        rows = self._batch_rows(bs)
        to_device = lambda mb: (mb[0], self._put_batch(mb[1]))  # noqa: E731
        if cfg.prefetch_batches > 0:
            batch_iter = prefetch_iter(batch_iter, size=cfg.prefetch_batches,
                                       transform=to_device,
                                       wait_span="trainer.batch_wait")
        else:
            batch_iter = map(to_device, batch_iter)
        for meta, batch, next_meta in _with_lookahead(batch_iter):
            if use_rag and meta.window_idx != current_wid:
                ctx = prefetched.pop(meta.window_idx, None)
                if ctx is None:
                    with span("trainer.window_context"):
                        ctx = self._window_ctx(ds, meta, level, seed)
                current_wid = meta.window_idx
            if (use_rag and cfg.prefetch_ctx and next_meta is not None
                    and next_meta.window_idx != current_wid
                    and next_meta.window_idx not in prefetched):
                prefetched.clear()
                with span("trainer.window_context"):
                    prefetched[next_meta.window_idx] = self._window_ctx(
                        ds, next_meta, level, seed)
            if k_chunk > 1:
                out = self.runner.run(batch, ctx, self.step)
                n = out["loss"].shape[0]
                stats = {"loss": out["loss"][n - 1]}
                self.step += n
                n_batches += n
            elif train:
                gen = step_generator(cfg.seed, self.step, self.device)
                with span("dispatch.chunk"):
                    stats, acc = train_step(self.model, self.optimizer,
                                            batch, ctx, self.step_cfg, gen,
                                            acc, self.data_group, rows)
                self.step += 1
                n_batches += 1
            else:
                stats, acc = eval_step(self.model, batch, ctx,
                                       self.step_cfg, acc, self.data_group)
                n_batches += 1
            if self.step_marks is not None:
                self.step_marks.append(time.time())
            if want_prof and prof is None:
                # after the first micro-step (kernel loads, allocator
                # warm-up): the next profile_steps are steady ones
                prof, prof_start_n = start_trace(self.device), n_batches
            elif want_prof and n_batches - prof_start_n >= cfg.profile_steps:
                self.trace_path = stop_trace(prof, cfg.profile_dir,
                                             self.device)
                want_prof = False
            if train and n_batches % cfg.log_freq == 0:
                self._log({"event": "step", "epoch": epoch,
                           "batch": n_batches,
                           "loss": float(stats["loss"])})
        if want_prof and prof is not None:      # a short epoch: close out
            self.trace_path = stop_trace(prof, cfg.profile_dir, self.device)
        host = _to_host(acc)                 # one copy to the host per epoch
        summary = metrics_lib.summarize(host["counters"])
        # the JAX package's column order (its pytree sorts the dict keys)
        summary.update({k: float(v) / max(n_batches, 1)
                        for k, v in sorted(host["totals"].items())})
        summary["epoch_seconds"] = time.time() - t0
        summary["n_batches"] = n_batches
        return summary

    def fit(self) -> dict:
        cfg = self.cfg
        history = []
        self.level = min(self.start_epoch // cfg.curriculum_every,
                         cfg.max_level)
        for epoch in range(self.start_epoch, cfg.epochs):
            tr = self._run_epoch(epoch, train=True)
            self._log({"event": "train_epoch", "epoch": epoch,
                       "level": self.level, **tr})
            row = {"epoch": epoch, "level": self.level,
                   **{f"train_{k}": v for k, v in tr.items()}}
            if self.has_validation:
                va = self._run_epoch(epoch, train=False)
                self._log({"event": "val_epoch", "epoch": epoch, **va})
                row.update({f"val_{k}": v for k, v in va.items()})
                metric = va.get(cfg.val_metric.replace("f1", "hap_f1")
                                if cfg.val_metric == "f1" else cfg.val_metric,
                                va["hap_f1"])
                is_best, should_stop = self.stopper.update(metric, epoch)
                self.save_checkpoint(epoch, is_best=is_best)
                if should_stop:
                    self._log({"event": "early_stop", "epoch": epoch,
                               "best_epoch": self.stopper.best_epoch,
                               "best": self.stopper.best})
                    self._write_csv_row(row)
                    history.append(row)
                    break
            else:
                self.save_checkpoint(epoch, is_best=False)
            self._write_csv_row(row)
            history.append(row)
            # curriculum: add_level every N epochs, capped
            if (epoch + 1) % cfg.curriculum_every == 0:
                self.level = min(self.level + 1, cfg.max_level)
        self.finalize()     # commit the last epoch's checkpoint
        return {"history": history, "best": self.stopper.best,
                "best_epoch": self.stopper.best_epoch}

    # ---- persistence ----

    def _ckpt_dir(self, epoch: int) -> str:
        return os.path.abspath(os.path.join(self.cfg.output_dir,
                                            f"ckpt_ep{epoch}"))

    def save_checkpoint(self, epoch: int, is_best: bool) -> None:
        """Save ``ckpt_ep{epoch}/state.pt`` (through a temporary file),
        point ``best`` at it when ``is_best``, and drop epoch dirs beyond
        ``keep_checkpoints`` (the best is always kept).

        The full tensors are gathered (a collective under tensor
        parallelism: every rank) and copied to the host here, on the
        calling thread: the update changes parameters and moments in
        place, so the file holds this moment's state whatever training
        does next.  With ``async_checkpoints`` the writer rank's file
        work runs on a background thread; at most one save is in flight
        (a new one waits for the previous commit, as orbax does).  A write
        that failed raises here, at the next save, or at ``finalize``."""
        path = self._ckpt_dir(epoch)
        opt = self.optimizer.state_dict()
        params = tp.gather_full(self.model.state_dict(), self.mesh)
        opt = {k: (tp.gather_full(v, self.mesh) if isinstance(v, dict)
                   else v) for k, v in opt.items()}
        if not self.writer:
            return
        payload = _host_copy({
            "params": params, "opt_state": opt,
            "step": self.step, "epoch": epoch, "level": self.level,
            "es_best": float(self.stopper.best),
            "es_best_epoch": self.stopper.best_epoch,
            "es_bad_epochs": self.stopper.bad_epochs})
        self.finalize()
        if not self.cfg.async_checkpoints:
            self._write_checkpoint(path, payload, epoch, is_best)
            return
        self._saver = threading.Thread(
            target=self._write_in_background,
            args=(path, payload, epoch, is_best),
            name=f"checkpoint-ep{epoch}")
        self._saver.start()

    def _write_in_background(self, *args) -> None:
        try:
            self._write_checkpoint(*args)
        except BaseException as e:     # re-raised by finalize
            self._save_error = e

    def _write_checkpoint(self, path: str, payload: dict, epoch: int,
                          is_best: bool) -> None:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))
        if is_best:
            best = os.path.join(self.cfg.output_dir, "best")
            if os.path.islink(best):
                os.unlink(best)
            os.symlink(path, best)
        self._gc_checkpoints(current_epoch=epoch)

    def finalize(self) -> None:
        """Wait until the checkpoint save in flight, if any, has committed
        (JAX trainer.py:547-550); re-raise its error if it failed."""
        if self._saver is not None:
            self._saver.join()
            self._saver = None
        err, self._save_error = self._save_error, None
        if err is not None:
            raise err

    def _gc_checkpoints(self, current_epoch: int) -> None:
        """Keep the newest ``keep_checkpoints`` epoch dirs + the best; only
        epochs before the current one are deleted."""
        keep = self.cfg.keep_checkpoints
        if keep <= 0:
            return
        best = os.path.join(self.cfg.output_dir, "best")
        best_target = os.path.realpath(best) if os.path.islink(best) else None
        epochs = []
        for name in os.listdir(self.cfg.output_dir):
            if name.startswith("ckpt_ep"):
                try:
                    epochs.append(int(name[len("ckpt_ep"):]))
                except ValueError:
                    continue
        for ep in sorted(epochs)[:-keep] if len(epochs) > keep else []:
            path = self._ckpt_dir(ep)
            if ep >= current_epoch or path == best_target:
                continue
            shutil.rmtree(path, ignore_errors=True)

    def restore_checkpoint(self, path: str) -> None:
        """Resume weights, optimizer, step, early-stop state and curriculum
        (train_embedding_rag.py:154-192, 325-336) from a checkpoint dir
        (after any save in flight has committed)."""
        self.finalize()
        state = torch.load(os.path.join(path, "state.pt"),
                           map_location=self.device, weights_only=True)
        self.model.load_state_dict(tp.shard_full(state["params"], self.mesh))
        self.optimizer.load_state_dict(
            {k: (tp.shard_full(v, self.mesh) if isinstance(v, dict) else v)
             for k, v in state["opt_state"].items()})
        self.step = int(state["step"])
        self.stopper.best = float(state["es_best"])
        self.stopper.best_epoch = int(state["es_best_epoch"])
        self.stopper.bad_epochs = int(state["es_bad_epochs"])
        self.start_epoch = int(state["epoch"]) + 1
        # Re-derive the curriculum level from the resume epoch (the saved
        # level predates the end-of-epoch bump), matching the reference's
        # target_level = min(start_epoch // 2, max) replay
        # (train_embedding_rag.py:325-336).
        self.level = min(self.start_epoch // self.cfg.curriculum_every,
                         self.cfg.max_level)

    def init_params_from(self, path: str) -> None:
        """Warm-start the weights from a checkpoint directory (a converted
        reference checkpoint from ``convert-ckpt``, or another run's
        ``ckpt_ep{N}``) while the optimizer, epoch and curriculum stay
        fresh: fine-tuning, where ``restore_checkpoint`` resumes exactly
        (JAX trainer.py:602-625).  The tree must match this trainer's model;
        any difference raises with the missing, extra and mis-shaped
        leaves.  ``FrozenBatchNorm`` statistics load into their buffers."""
        from ..interop import (flax_params_of, leaf_shapes, load_flax_params,
                               load_params_checkpoint)

        self.finalize()      # the checkpoint may be this run's, in flight
        loaded = load_params_checkpoint(path)
        full = tp.gather_full(self.model.state_dict(), self.mesh)
        cur, new = leaf_shapes(flax_params_of(full)), leaf_shapes(loaded)
        if cur != new:
            missing = sorted(set(cur) - set(new))[:5]
            extra = sorted(set(new) - set(cur))[:5]
            shapes = sorted(k for k in cur if k in new
                            and cur[k] != new[k])[:5]
            raise ValueError(
                f"checkpoint params do not match the model: "
                f"missing={missing} extra={extra} shape_mismatch={shapes}")
        if self.mesh is None:
            load_flax_params(self.model, loaded)
            return
        state = {k: v.clone() for k, v in full.items()}
        load_flax_params(state, loaded)
        self.model.load_state_dict(tp.shard_full(state, self.mesh))

    # ---- logging ----

    def _log(self, record: dict) -> None:
        if not self.writer:
            return
        record = {**record, "ts": time.time()}
        with open(self.log_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")

    def _write_csv_row(self, row: dict) -> None:
        if not self.writer:
            return
        exists = os.path.exists(self.csv_path)
        with open(self.csv_path, "a", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(row.keys()))
            if not exists:
                w.writeheader()
            w.writerow(row)

