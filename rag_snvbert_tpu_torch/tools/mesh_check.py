"""The scale-out path across cards: run under torchrun, one rank a card.

    torchrun --standalone --nproc-per-node 4 \\
        -m rag_snvbert_tpu_torch.tools.mesh_check

Every rank joins the process group (NCCL; gloo with ``--device cpu``) and
runs, against the same work in one process on rank 0:

  1. dp x idx training: ``tpu_default`` on a seeded bundle (2 windows of
     1020 sites, 2008 reference haplotypes padded to a 2048-row context,
     48 samples), one epoch at global batch 24 with accumulation 2 (4
     micro-steps) over a mesh of n/2 data x 2 index ranks, held to the
     single process by ``compare_fits``; the time of one gradient
     all-reduce; and, with more than one data rank, the same fit with
     the gradient sum over the data group skipped, a control that those
     checks must fail;
  2. dp x tp training: the same fit over n/2 data x 2 model ranks, where
     each rank's 192 columns split one of ``tpu_default``'s three heads
     of 128, held to the same single-process fit; the same fit with the
     split head's gradient sum skipped (``split_head_control``), a
     control that must fail; and an ``int8_matmuls=True`` fit over the
     same mesh held to its own single-process fit;
  3. the genotype index (664,648 rows x 2040, 1024 queries, k = 10) over
     n index shards in four storages, each searched with both merges:
     ids and distances equal to ``FlatL2Index``'s.

Rank 0 prints the card, each part's times and every rank's kernel
launches, and last one JSON line; a failed check exits non-zero.
``--small`` shrinks the model, bundle and index for a CPU rehearsal.

The training harness (``make_trainer``, ``fit``, ``compare_fits``,
``fit_failures``) and the index's inputs (``index_bits``, ``STORAGES``)
are also what ``chip_smoke.py`` runs in its gloo worlds on one card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import sys
import time

import torch
import torch.distributed as dist

from .. import ops
from ..config import PRESETS, RunConfig, build_model
from ..data.pipeline import WindowDataset
from ..index import FlatL2Index, ShardedFlatL2Index
from ..io.synthetic import make_bundle
from ..parallel import tp
from ..parallel.mesh import init_distributed, is_writer, make_mesh
from ..train import step as step_mod
from ..train import trainer as trainer_mod
from ..train.trainer import Trainer, TrainerConfig

# A mesh fit against the single-process one (bf16 on the card, rows
# batched differently): the epoch loss and every parameter to LOSS_TOL /
# PARAM_TOL relative (a parameter tensor relative to the larger of 1 and
# its largest entry); each micro-step's gradient norm after the sum over
# the data group to NORM_TOL relative; and the fit's parameter change to
# DELTA_TOL in L2 relative to the single fit's change.  The gradient norm
# is the check of the sum: a gradient averaged, halved or left unsummed
# is off by tens of percent, while Adam's first updates move a parameter
# by about the learning rate whatever its gradient's scale, so the
# parameters cannot show it.  The micro-steps before the first update
# agree to a few 1e-6, the later ones to a few 1e-4 (the first update
# moves parameters whose gradient is rounding noise by +-lr), hence
# NORM_TOL.  The parameter change catches an update lost or applied
# twice (a rank without the sum only flips the sign of a few per cent of
# the first steps: 0.28 at the CPU rehearsal's size).
LOSS_TOL = PARAM_TOL = NORM_TOL = 1e-3
DELTA_TOL = 0.05
# A fit over a model axis sums each block's two row-parallel products in
# bf16 (one more bf16 rounding, 2^-9, of every block's output, as
# GSPMD's bf16 all-reduce does), so its gradient norms and parameter
# change drift further from the single fit than a data-parallel fit's:
# 8.5e-4 and 0.049 at the CPU rehearsal's size, where skipping a split
# head's gradient sum (the control) gives 1.4e-3 and 0.25.
TP_NORM_TOL, TP_DELTA_TOL = 5e-3, 0.1
BUNDLE = dict(n_train_samples=48, n_ref_samples=1004, n_sites=2 * 1020,
              n_windows=2, seed=23)
INDEX_SEED = 11
# (name, FlatL2Index.build arguments, the kernel that searches a shard of
# the genotype index on the card)
STORAGES = (("packed", dict(pack=8), "l2_topk_rf"),
            ("int8", dict(dtype=torch.int8), "l2_topk_rf"),
            ("bf16", dict(dtype=torch.bfloat16), "l2_topk_float"),
            ("f32", dict(dtype=torch.float32), "l2_topk_float"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _config(small: bool) -> tuple[RunConfig, dict, tuple[int, int, int]]:
    """The preset, the bundle's arguments and the index's (N, d, B)."""
    cfg = PRESETS["tpu_default"]
    bundle = dict(BUNDLE)
    index = (331 * 2008, 2040, 1024)
    if small:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dims=48, n_layers=2, seq_len=80, flash_attention=False))
        bundle.update(n_ref_samples=10, n_sites=120)
        index = (3001, 40, 16)
    return cfg, bundle, index


def make_trainer(mesh, out_dir: str, cfg: RunConfig | None = None,
                 bundle: dict | None = None, device=None
                 ) -> tuple[Trainer, WindowDataset]:
    """``cfg`` (default ``tpu_default``) over ``bundle`` (default
    ``BUNDLE``: 2 windows of a 2048-row context, 48 samples): one epoch of
    4 micro-steps at global batch 24, gradient accumulation 2, no
    validation; the trainer and its dataset."""
    cfg = cfg or PRESETS["tpu_default"]
    b = make_bundle(**(bundle or BUNDLE))
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=cfg.model.seq_len)
    tcfg = TrainerConfig(
        epochs=1, batch_size=cfg.batch_size, val_batch_size=cfg.batch_size,
        init_lr=cfg.init_lr, max_lr=cfg.max_lr, warmup_steps=cfg.warmup_steps,
        grad_accum_steps=cfg.grad_accum_steps, focal_gamma=cfg.focal_gamma,
        rag_k=cfg.rag_k, ref_pad_haps=2048, output_dir=out_dir,
        log_freq=1000, seed=0, record_step_times=True)
    model = build_model(cfg, b.vocab.size, device=device, seed=0)
    return Trainer(model, ds, tcfg, mesh=mesh), ds


@contextlib.contextmanager
def _recording(sum_gradients: bool):
    """``Trainer.fit``'s micro-steps with each one's gradient norm (a
    device tensor) appended to the list yielded; ``sum_gradients=False``
    skips the gradient sum over the data group (the control)."""
    norms: list[torch.Tensor] = []
    real_step, real_sum = trainer_mod.train_step, step_mod.sum_gradients

    def train_step(*args, **kwargs):
        stats, acc = real_step(*args, **kwargs)
        norms.append(stats["grad_norm"])
        return stats, acc

    trainer_mod.train_step = train_step
    if not sum_gradients:
        step_mod.sum_gradients = lambda optimizer, group: None
    try:
        yield norms
    finally:
        trainer_mod.train_step, step_mod.sum_gradients = real_step, real_sum


def _full_params(trainer) -> dict:
    full = tp.gather_full(trainer.model.state_dict(), trainer.mesh)
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in full.items()}


def fit(trainer: Trainer, sum_gradients: bool = True) -> dict:
    """One epoch of ``trainer.fit()``: its loss, the full parameters
    before and after on the host, each micro-step's gradient norm, the
    wall seconds and the host-clock ms between micro-steps."""
    device = trainer.device
    before = _full_params(trainer)
    _sync(device)
    t = time.perf_counter()
    with _recording(sum_gradients) as norms:
        loss = trainer.fit()["history"][0]["train_loss"]
    _sync(device)
    wall = time.perf_counter() - t
    marks = trainer.step_marks
    return {"loss": loss, "wall_s": wall,
            "step_ms": [(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
            "grad_norms": [float(n) for n in norms],
            "params": _full_params(trainer), "before": before}


def compare_fits(got: dict, want: dict) -> dict:
    """How far ``got`` (a mesh fit) is from ``want`` (the single-process
    fit of the same work): relative loss, parameters (per tensor, relative
    to the larger of 1 and its largest entry), gradient norms (worst
    micro-step) and parameter change (L2 over every tensor)."""
    loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    params = max(float((got["params"][k] - v).abs().max()
                       / max(float(v.abs().max()), 1.0))
                 for k, v in want["params"].items())
    norms = [abs(a - b) / b for a, b in zip(got["grad_norms"],
                                            want["grad_norms"])]
    if len(got["grad_norms"]) != len(want["grad_norms"]):
        norms.append(float("inf"))
    num = den = 0.0
    for k, v in want["params"].items():
        step = v - want["before"][k]
        num += float(((got["params"][k] - got["before"][k]) - step)
                     .square().sum())
        den += float(step.square().sum())
    return {"loss_rel": loss, "param_rel": params, "norm_rel": max(norms),
            "norm_rels": norms, "delta_rel": (num / den) ** 0.5}


def fit_failures(c: dict, model_axis: bool = False) -> list[str]:
    """The checks of ``compare_fits`` that ``c`` fails (``model_axis``: a
    fit over a model axis, held to ``TP_NORM_TOL`` and ``TP_DELTA_TOL``)."""
    tols = {"loss_rel": LOSS_TOL, "param_rel": PARAM_TOL,
            "norm_rel": TP_NORM_TOL if model_axis else NORM_TOL,
            "delta_rel": TP_DELTA_TOL if model_axis else DELTA_TOL}
    return [f"{k} {c[k]:.2e} > {tol}" for k, tol in tols.items()
            if not c[k] <= tol]


@contextlib.contextmanager
def split_head_control():
    """The gather of a split head's columns with its backward's sum over
    the group skipped (each rank keeps only its own attention's part of
    the head's q and k gradient): a fit under it must fail
    ``compare_fits``."""
    from ..parallel import comm

    real = comm._GatherFromGroup.backward

    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.width, ctx.width), None

    comm._GatherFromGroup.backward = staticmethod(backward)
    try:
        yield
    finally:
        comm._GatherFromGroup.backward = staticmethod(real)


def allreduce_ms(trainer: Trainer) -> float:
    """Median ms of one micro-step's gradient sum over the data group
    (``train.step.sum_gradients``: every parameter's gradient in float32,
    one collective), device-synchronized before and after; five calls
    after a warm one."""
    times = []
    for _ in range(6):
        _sync(trainer.device)
        t = time.perf_counter()
        step_mod.sum_gradients(trainer.optimizer, trainer.data_group)
        _sync(trainer.device)
        times.append((time.perf_counter() - t) * 1e3)
    trainer.optimizer.zero_grad()
    return statistics.median(times[1:])


def index_bits(n: int, d: int, b: int, device) -> tuple:
    """The genotype index's ``[n, d]`` int8 bits and ``[b, d]`` float32
    queries, from ``INDEX_SEED`` on ``device`` (the same on every rank)."""
    gen = torch.Generator(device=device).manual_seed(INDEX_SEED)
    bits = torch.randint(0, 2, (n, d), generator=gen, device=device,
                         dtype=torch.int8)
    q = torch.randint(0, 2, (b, d), generator=gen, device=device).float()
    return bits, q


def _timed(fn, device) -> tuple[float, tuple]:
    fn()                                      # warm
    _sync(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    return (time.perf_counter() - t) * 1e3, out


def _gather_objects(obj) -> list:
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, obj)
    return every


def run(small: bool, device: torch.device, out_dir: str) -> dict:
    """Both parts on this rank; the report (rank 0's has the checks)."""
    world = dist.get_world_size()
    cfg, bundle, (n, d, b) = _config(small)
    report: dict = {"world": world, "backend": dist.get_backend()}
    failures: list[str] = []

    # 1. dp x idx training against one process, then the control
    single = None
    if is_writer():
        single = fit(make_trainer(None, os.path.join(out_dir, "single"),
                                  cfg, bundle, device)[0])
    dist.barrier()
    mesh = make_mesh(world // 2, 2, 1, device=device)
    ops.reset_launches()
    trainer = make_trainer(mesh, os.path.join(out_dir, "mesh"), cfg, bundle,
                           device)[0]
    got = fit(trainer)
    launches = _gather_objects(ops.launch_counts())
    reduce_ms = allreduce_ms(trainer)
    del trainer
    control = None
    if world // 2 > 1:         # a data group to sum over
        control = fit(make_trainer(mesh, os.path.join(out_dir, "control"),
                                   cfg, bundle, device)[0],
                      sum_gradients=False)
    if is_writer():
        c = compare_fits(got, single)
        cc = control and compare_fits(control, single)
        report["train"] = {
            "mesh": f"{world // 2}x2x1", "loss": got["loss"],
            "single_loss": single["loss"], **c,
            "tol": {"loss": LOSS_TOL, "param": PARAM_TOL, "norm": NORM_TOL,
                    "delta": DELTA_TOL},
            "control_without_gradient_sum": cc,
            "wall_s": got["wall_s"], "single_wall_s": single["wall_s"],
            "step_ms_median": statistics.median(got["step_ms"]),
            "single_step_ms_median": statistics.median(single["step_ms"]),
            "grad_allreduce_ms": reduce_ms, "launches": launches}
        failures += [f"training: {x}" for x in fit_failures(c)]
        if cc and not (cc["norm_rel"] > NORM_TOL
                       and cc["delta_rel"] > DELTA_TOL):
            failures.append(f"the control without the gradient sum passes "
                            f"the training checks: {cc}")

    # 2. dp x tp training (a split head), its control, and int8 at tp2
    int8 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, int8_matmuls=True))
    single8 = None
    if is_writer():
        single8 = fit(make_trainer(None, os.path.join(out_dir, "single8"),
                                   int8, bundle, device)[0])
    dist.barrier()
    mesh = make_mesh(world // 2, 1, 2, device=device)
    ops.reset_launches()
    trainer = make_trainer(mesh, os.path.join(out_dir, "tp"), cfg, bundle,
                           device)[0]
    att = trainer.model.bert.encoder.block_0.attention
    heads = (att.local_heads, att.head_split)
    got = fit(trainer)
    launches = _gather_objects(ops.launch_counts())
    del trainer
    with split_head_control():
        control = fit(make_trainer(mesh, os.path.join(out_dir, "tp_control"),
                                   cfg, bundle, device)[0])
    got8 = fit(make_trainer(mesh, os.path.join(out_dir, "tp_int8"), int8,
                            bundle, device)[0])
    heads = _gather_objects(heads)
    if is_writer():
        c, cc, c8 = (compare_fits(got, single), compare_fits(control, single),
                     compare_fits(got8, single8))
        report["tp"] = {
            "mesh": f"{world // 2}x1x2", "heads": heads, **c,
            "tol": {"norm": TP_NORM_TOL, "delta": TP_DELTA_TOL},
            "control_split_head_without_sum": cc, "int8": c8,
            "step_ms_median": statistics.median(got["step_ms"]),
            "int8_step_ms_median": statistics.median(got8["step_ms"]),
            "single_int8_step_ms_median": statistics.median(
                single8["step_ms"]), "launches": launches}
        failures += [f"dp x tp training: {x}"
                     for x in fit_failures(c, model_axis=True)]
        failures += [f"dp x tp int8 training: {x}"
                     for x in fit_failures(c8, model_axis=True)]
        if not fit_failures(cc, model_axis=True):
            failures.append(f"the control without the split head's "
                            f"gradient sum passes the training checks: {cc}")

    # 3. the genotype index over every rank
    mesh = make_mesh(1, world, 1, device=device)
    bits, q = index_bits(n, d, b, device)
    ops.reset_launches()
    rows = {}
    for name, kw, _ in STORAGES:
        idx = ShardedFlatL2Index.build(mesh, bits, device=device, **kw)
        for merge in ("all_gather", "ring"):
            rows[name, merge] = _timed(lambda: idx.search(q, 10, merge=merge),
                                       device)
        del idx
    launches = _gather_objects(ops.launch_counts())
    if is_writer():
        report["index"] = {"shape": [b, n, d], "launches": launches}
        for name, kw, _ in STORAGES:
            one = FlatL2Index.build(bits, device=device, **kw)
            one_ms, (sv, si) = _timed(
                lambda: one.search(q, 10, use_pallas=device.type == "cuda"),
                device)
            del one
            entry = {"single_ms": one_ms}
            for merge in ("all_gather", "ring"):
                ms, (v, i) = rows[name, merge]
                entry[merge + "_ms"] = ms
                if not (torch.equal(v, sv) and torch.equal(i, si)):
                    failures.append(f"index {name} ({merge}) differs from "
                                    "FlatL2Index")
            report["index"][name] = entry
    report["failures"] = failures
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="'cpu' for a gloo rehearsal; default: the card")
    p.add_argument("--small", action="store_true",
                   help="a small model, bundle and index (CPU rehearsal)")
    p.add_argument("--out", default="runs/mesh_check",
                   help="the trainers' output directory")
    args = p.parse_args(argv)
    cpu = args.device == "cpu"
    init_distributed("gloo" if cpu else "nccl")
    device = (torch.device("cpu") if cpu else
              torch.device("cuda", torch.cuda.current_device()))
    writer = is_writer()
    try:
        if writer:
            shutil.rmtree(args.out, ignore_errors=True)
            if not cpu:
                import subprocess

                ops._build.build()       # once, before the ranks load them
                print(subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, check=True).stdout.strip(), flush=True)
        dist.barrier()
        report = run(args.small, device, args.out)
        # rank 0's checks, known to every rank so that all exit alike
        failures = _gather_objects(report["failures"])[0]
    finally:
        dist.destroy_process_group()
    if writer:
        print(json.dumps(report), flush=True)
    if failures:
        print("FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
