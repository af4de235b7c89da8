"""Closed-loop training: the program's ``Trainer`` epoch loop over the
panel's windows, epochs repeated until the window closes.

Set-up builds the one ``Trainer`` (model with the seed's weights, the
optimizer, the chunk runner) and runs epoch 0 through it on the first
``batch x steps_per_dispatch`` samples, one chunk a window: it warms
every shape (the CUDA graph of a chunk, each window's context) and, in its
first ``check_micro_steps`` micro-steps, records what the check compares:
each micro-step's loss, the optimizer's first moment and the
parameters.  The
window runs epochs 1, 2, ... as ``Trainer.fit`` does (the curriculum
level rises every ``curriculum_every`` epochs), without validation or
checkpoints; ``train_samples_per_s`` is the micro-steps finished times the
batch over the window's seconds, each epoch ending in a copy of its
counters to the host.

The check frees the program, runs the plain reference through the same
first micro-steps from the same seed (weights, masks, window context,
retrieval, dropout draws, the update) and compares by the worst of each:
the loss's relative gap; per parameter, the gap of the first moment's
norm (the gradients as the optimizer got them) and of the change's norm,
each over the larger of the reference leaf's norm and the median leaf's.
Leaves whose reference first moment is under a thousandth of the median
leaf's (gradients nought to rounding) are left out of both.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import panel as panel_mod
from benchmark import program, weights
from benchmark.reference import data as ref_data
from benchmark.reference import model as ref_model
from benchmark.reference import retrieval as ref_retrieval
from benchmark.reference import train as ref_train


def make_panel(run):
    w = run.param("n_windows")
    return panel_mod.make_panel(
        n_train_samples=run.param("samples_per_window"),
        n_ref_samples=run.param("n_ref_samples"),
        n_sites=w * run.param("sites_per_window"), n_windows=w,
        seed=run.seed)


def setup(run) -> dict:
    from rag_snvbert_tpu_torch.data.pipeline import WindowDataset
    from rag_snvbert_tpu_torch.io.panel import PanelData
    from rag_snvbert_tpu_torch.train import trainer as trainer_mod

    rc = program.preset(run)
    panel = make_panel(run)
    names = [f"TR{i:04d}" for i in range(panel.train_gt.shape[1])]
    refs = [f"RF{i:04d}" for i in range(panel.ref_gt.shape[1])]
    vocab = program.vocab_of(panel)
    ds = WindowDataset(program.vcf(panel.train_gt, panel.positions, names),
                       PanelData.from_lists(names, panel.train_pops),
                       program.freq_table(panel), panel.window_info, vocab,
                       ref_vcf=program.vcf(panel.ref_gt, panel.positions,
                                           refs),
                       seq_len=rc.model.seq_len)
    model = program.build_model(rc, vocab.size, run.seed, run.device)
    k = int(run.param("steps_per_dispatch"))
    cfg = trainer_mod.TrainerConfig(
        epochs=1 << 30, batch_size=rc.batch_size,
        val_batch_size=rc.val_batch_size, init_lr=rc.init_lr,
        max_lr=rc.max_lr, warmup_steps=rc.warmup_steps,
        grad_accum_steps=rc.grad_accum_steps, focal_gamma=rc.focal_gamma,
        use_recon_loss=rc.use_recon_loss, rag_k=rc.rag_k,
        rare_threshold=rc.rare_threshold,
        ref_pad_haps=run.param("ref_pad_haps"), rag_mode=rc.model.rag_mode,
        output_dir=os.path.join(run.tmp, "train"), log_freq=1 << 30,
        seed=run.seed, steps_per_dispatch=k, async_checkpoints=False)
    trainer = trainer_mod.Trainer(model, ds, cfg)
    state = {"trainer": trainer, "panel": panel, "vocab": vocab.size,
             "rc": rc, "epoch": 0}
    n_check = int(run.param("check_micro_steps"))
    snap = {"loss": []}

    def record():
        opt = trainer.optimizer
        snap["mu"] = {n: t.detach().float().cpu().clone()
                      for n, t in zip(opt.names, opt.mu)}
        snap["params"] = {n: p.detach().float().cpu().clone()
                          for n, p in model.named_parameters()}

    # The first micro-steps' readings, from the calls the window makes.
    if trainer.runner is not None:
        runner_run = trainer.runner.run

        def run_chunk(batches, ctx, step):
            out = runner_run(batches, ctx, step)
            if "mu" not in snap:
                snap["loss"] += out["loss"].float().cpu().tolist()
                if len(snap["loss"]) >= n_check:
                    record()
            return out

        trainer.runner.run = run_chunk
    else:
        step_fn = trainer_mod.train_step

        def one_step(*args, **kw):
            stats, acc = step_fn(*args, **kw)
            if "mu" not in snap:
                snap["loss"].append(float(stats["loss"]))
                if len(snap["loss"]) >= n_check:
                    record()
            return stats, acc

        trainer_mod.train_step = one_step
    # Epoch 0, the warm-up, trains one chunk a window (batch x K samples):
    # every shape of the window (the chunk's graph, each window's
    # context) without the rest of an epoch.
    trainer.train_sample_ids = np.arange(rc.batch_size * k)
    try:
        _epoch(trainer, state)
    finally:
        trainer.train_sample_ids = None
        if trainer.runner is not None:
            trainer.runner.run = runner_run
        else:
            trainer_mod.train_step = step_fn
    if "mu" not in snap:
        raise RuntimeError(f"epoch 0 ran fewer than {n_check} micro-steps")
    snap["loss"] = snap["loss"][:n_check]
    state["snap"] = snap
    return state


def _epoch(trainer, state) -> dict:
    """One training epoch, then the curriculum step ``Trainer.fit``
    takes."""
    epoch = state["epoch"]
    with torch.profiler.record_function("bench.epoch"):
        summary = trainer._run_epoch(epoch, train=True)
    if (epoch + 1) % trainer.cfg.curriculum_every == 0:
        trainer.level = min(trainer.level + 1, trainer.cfg.max_level)
    state["epoch"] = epoch + 1
    return summary


def window(run, state, seconds: float) -> dict:
    trainer = state["trainer"]
    steps = epochs = 0
    t0 = time.perf_counter()
    while True:
        steps += _epoch(trainer, state)["n_batches"]
        epochs += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0    # the epoch's counters are on the host
    bs = trainer.cfg.batch_size
    counts = {"micro_steps": steps, "samples": steps * bs, "epochs": epochs,
              "window_contexts": epochs * trainer.train_ds.n_windows,
              "batch_size": bs,
              "context_rows": int(run.param("ref_pad_haps")),
              "seq_len": int(state["rc"].model.seq_len)}
    return {"metrics": {"train_samples_per_s": steps * bs / elapsed},
            "counts": counts, "attempted": steps, "failed": 0,
            "window_s": elapsed}


# ---- the check ----

def reference_readings(run, state, precision=None, keep_rows=None) -> dict:
    """The reference's losses, first moment and parameters after the
    check's micro-steps of epoch 0, computed on ``run.device`` in
    ``precision`` (``reference/numerics.py``; None: float32)."""
    rc, panel = state["rc"], state["panel"]
    dev = run.device
    mb = program.model_block(run)
    ref = ref_model.from_config(mb, state["vocab"]).to(dev)
    weights.fill(ref, run.seed)
    ref_model.set_precision(ref, precision)
    p0 = {n: p.detach().clone() for n, p in ref.named_parameters()}
    L = rc.model.seq_len
    wins = ref_data.Windows(panel, L)
    n = int(run.param("check_micro_steps"))
    warm = rc.batch_size * int(run.param("steps_per_dispatch"))
    order = ref_data.epoch_order(len(panel.window_info), warm,
                                 rc.batch_size, epoch=0)[:n]
    params = dict(ref.named_parameters())
    opt = ref_train.Adam(params, rc.init_lr, rc.max_lr, rc.warmup_steps,
                         rc.grad_accum_steps)
    losses, ctx_w, ctx = [], None, None
    for step, (w, ids) in enumerate(order):
        batch = wins.train_batch(w, ids, level=0, seed=0)
        if w != ctx_w:
            toks, valid = wins.ref_tokens(w, int(run.param("ref_pad_haps")))
            toks = torch.as_tensor(toks, device=dev)
            wmask = torch.as_tensor(batch["window_mask"], device=dev)
            valid = torch.as_tensor(valid, device=dev)
            if mb["rag_mode"] == "token":
                ctx = (toks, wmask, valid)
            else:
                af = torch.as_tensor(ref_data.pad(wins.af(w), L),
                                     device=dev).float()
                ctx = ref_retrieval.embedding_context(ref, toks, wmask, af,
                                                      valid)
            ctx_w = w
        loss, grads = ref_train.micro_step(ref, batch, ctx, run.seed, step,
                                           mb["rag_mode"], dev, keep_rows)
        opt.step(grads)
        losses.append(loss)
        del grads
    out = {"loss": losses,
           "mu": {k: v.detach().cpu() for k, v in opt.mu.items()},
           "delta": {k: (params[k].detach() - p0[k]).cpu() for k in params}}
    del ref, opt, params, p0, ctx
    program.free_cuda()
    return out


def _norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def gaps(got: dict, want: dict) -> dict:
    """The numbers compared: ``loss`` (the worst micro-step's relative
    gap), ``grad`` and ``update`` (the worst leaf's gap of norms over the
    larger of its reference norm and the median leaf's)."""
    out = {"loss": max(abs(a - b) / abs(b) for a, b in
                       zip(got["loss"], want["loss"]))}
    mu_ref = _norms(want["mu"])
    med = float(np.median(list(mu_ref.values())))
    kept = [k for k, v in mu_ref.items() if v >= 1e-3 * med]
    for name, key in (("grad", "mu"), ("update", "delta")):
        g, w = _norms(got[key]), _norms(want[key])
        m = float(np.median([w[k] for k in kept]))
        out[name] = max(abs(g[k] - w[k]) / max(w[k], m) for k in kept)
    return out


def worst_leaves(got: dict, want: dict) -> dict:
    """For calibration: which leaf sets ``grad`` and ``update``, with its
    norms on both sides and the median leaf's."""
    mu_ref = _norms(want["mu"])
    med = float(np.median(list(mu_ref.values())))
    kept = [k for k, v in mu_ref.items() if v >= 1e-3 * med]
    out = {}
    for name, key in (("grad", "mu"), ("update", "delta")):
        g, w = _norms(got[key]), _norms(want[key])
        m = float(np.median([w[k] for k in kept]))
        k = max(kept, key=lambda k: abs(g[k] - w[k]) / max(w[k], m))
        out[name] = {"leaf": k, "program": g[k], "reference": w[k],
                     "median": m}
    return out


def program_readings(state) -> dict:
    snap = state["snap"]
    return {"loss": snap["loss"], "mu": snap["mu"],
            "delta": {k: snap["params"][k] - v for k, v in
                      state["p0"].items()}}


def initial_params(run, state) -> dict:
    """The initial parameters again, from the seed."""
    ref = ref_model.from_config(program.model_block(run), state["vocab"])
    weights.fill(ref.to(run.device), run.seed)
    return {n: p.detach().float().cpu() for n, p in ref.named_parameters()}


def check(run, state) -> list[dict]:
    state.pop("trainer", None)
    program.free_cuda()
    want = reference_readings(run, state)
    state["p0"] = initial_params(run, state)
    got = program_readings(state)
    limits = run.param("limits")
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in gaps(got, want).items()]


def calibrate(run, state, control: str | None, faults: bool) -> dict:
    """The readings the limits are set from: the program's, the control's
    (the reference in ``control`` precision in the program's place) and,
    with ``faults``, those of half of each batch left out (its sum scaled
    to the whole batch)."""
    state.pop("trainer", None)
    program.free_cuda()
    want = reference_readings(run, state)
    state["p0"] = initial_params(run, state)
    got = program_readings(state)
    out = {"program": gaps(got, want), "worst": worst_leaves(got, want)}
    if control:
        out["control"] = gaps(reference_readings(run, state, control), want)
    if faults:
        bs = state["rc"].batch_size
        half = reference_readings(run, state,
                                  keep_rows=list(range(bs // 2)))
        out["half_batch"] = gaps(half, want)
    return out
