"""Chromosome-scale convergence run of the port: the evidence that the full
trainer (validation each epoch, the rare/common F1 split, curriculum
bumps, early stopping, checkpoints, resume) trains to quality on the card.

The port of tools/run_convergence.py, with the same flags, defaults,
stratified train/validation split, ``--train-subsample`` draw and outputs,
so a run here sits beside the JAX package's ``artifacts/convergence_r5/``.
It drives ``Trainer.fit()`` on the calibrated synthetic panel (neutral
site-frequency spectrum + linkage disequilibrium;
``io/synthetic.py::make_calibrated_bundle``) and writes the run directory:
``metrics.csv`` (per-epoch train/val rows with rare_f1/common_f1, the JAX
header), ``events.jsonl``, checkpoints (``ckpt_ep*``, ``best``),
``summary.json`` (the latest invocation's summary) and
``summary_history.jsonl`` (one line an invocation), and with ``--profile``
a torch.profiler trace of 4 steady micro-steps of the first epoch under
``<out>/profile`` (``tools/summarize_trace.py`` reads it).

    python -m rag_snvbert_tpu_torch.tools.run_convergence \
        --out runs/convergence_port --epochs 2
    python -m rag_snvbert_tpu_torch.tools.run_convergence \
        --out runs/convergence_port --epochs 4 --resume
        # restores the newest checkpoint, replays the curriculum
    python -m rag_snvbert_tpu_torch.tools.run_convergence \
        --out runs/convergence_port --steps-per-dispatch 4
        # each chunk of 4 micro-steps of a window runs as one graph replay

The model trains on the card unless ``--device cpu`` is given.  The bundle
is a pure function of (--seed, shape flags), so a resumed run regenerates
identical data.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tpu_default")
    ap.add_argument("--out", default="runs/convergence_r4")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--windows", type=int, default=331)
    ap.add_argument("--samples", type=int, default=1004)
    ap.add_argument("--ref-samples", type=int, default=1004)
    ap.add_argument("--val-fraction", type=float, default=0.05)
    ap.add_argument("--train-subsample", type=int, default=0,
                    help="if >0, deterministically subsample the TRAIN "
                    "cohort to this many samples AFTER the stratified "
                    "split: the panel, reference haplotypes, windows and "
                    "validation split stay those of the full run, so "
                    "validation F1 stays comparable across runs and with "
                    "tools/oracle_ceiling.py; only the epoch shrinks")
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--curriculum-every", type=int, default=1,
                    help="epochs per mask-curriculum level bump (the "
                    "reference bumps every 2, train_embedding_rag.py:"
                    "415-431; 1 reaches the 80%% terminal level at epoch "
                    "5)")
    ap.add_argument("--warmup-steps", type=int, default=3000)
    ap.add_argument("--max-lr", type=float, default=7.5e-5)
    ap.add_argument("--patience", type=int, default=5,
                    help="early-stop patience (5 = reference default, "
                    "pretrain_with_val_optimized.py:490-522)")
    ap.add_argument("--min-delta", type=float, default=0.001,
                    help="early-stop min improvement (reference default)")
    ap.add_argument("--log-freq", type=int, default=500)
    ap.add_argument("--ref-pad-haps", type=int, default=2048,
                    help="pad each window's reference set to this many "
                    "haps (2048 = the full chr21-scale panel; smaller for "
                    "smoke runs: the padded context sets the memory)")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="train K micro-steps of a window per dispatch "
                    "(one CUDA graph replay a chunk on the card; the JAX "
                    "train verb's --steps-per-dispatch); 1 = step by step")
    ap.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler trace of 4 steady train "
                    "micro-steps into <out>/profile")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest ckpt_ep* under --out and "
                    "continue (exercises restore + curriculum replay)")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' to run off the card")
    return ap


def split_samples(bundle, val_fraction: float, seed: int,
                  train_subsample: int = 0):
    """The JAX tool's stratified split and ``--train-subsample`` draw:
    ``(train_ids, val_ids)``."""
    train_ids, val_ids = bundle.panel.split_stratified(val_fraction,
                                                       seed=seed)
    if train_subsample and train_subsample < len(train_ids):
        rng = np.random.default_rng(seed)
        keep = rng.choice(len(train_ids), train_subsample, replace=False)
        train_ids = np.sort(np.asarray(train_ids)[keep])
    return train_ids, val_ids


def main(argv=None) -> dict:
    from ..config import PRESETS, build_model
    from ..data.pipeline import WindowDataset
    from ..device import resolve_device
    from ..io.synthetic import make_calibrated_bundle
    from ..train.trainer import Trainer, TrainerConfig

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    run = PRESETS[args.preset]
    seq_len = run.model.seq_len
    win = seq_len - 10
    t0 = time.time()
    print(f"building calibrated panel: {args.samples} samples, "
          f"{2 * args.ref_samples} ref haps, {win * args.windows} sites, "
          f"{args.windows} windows", file=sys.stderr)
    b = make_calibrated_bundle(n_train_samples=args.samples,
                               n_ref_samples=args.ref_samples,
                               n_sites=win * args.windows,
                               n_windows=args.windows, seed=args.seed)
    print(f"panel built in {time.time() - t0:.0f}s", file=sys.stderr)
    train_ids, val_ids = split_samples(b, args.val_fraction, args.seed,
                                       args.train_subsample)
    if args.train_subsample:
        print(f"train cohort subsampled to {len(train_ids)} "
              f"(val split unchanged: {len(val_ids)})", file=sys.stderr)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=seq_len)
    # weights from the run's seed, as the JAX trainer draws its init
    model = build_model(run, b.vocab.size, device=device, seed=args.seed)
    cfg = TrainerConfig(
        epochs=args.epochs, batch_size=run.batch_size,
        warmup_steps=args.warmup_steps, max_lr=args.max_lr,
        focal_gamma=run.focal_gamma, rag_k=run.rag_k,
        curriculum_every=args.curriculum_every, patience=args.patience,
        min_delta=args.min_delta, rag_mode=run.model.rag_mode,
        ref_pad_haps=args.ref_pad_haps, output_dir=args.out,
        log_freq=args.log_freq, seed=args.seed, keep_checkpoints=2,
        steps_per_dispatch=args.steps_per_dispatch,
        profile_dir=os.path.join(args.out, "profile") if args.profile
        else None)
    tr = Trainer(model, ds, cfg, train_sample_ids=train_ids,
                 val_sample_ids=val_ids)

    if args.resume:
        cks = sorted((n for n in os.listdir(args.out)
                      if n.startswith("ckpt_ep")),
                     key=lambda n: int(n[len("ckpt_ep"):]))
        if not cks:
            sys.exit(f"--resume: no ckpt_ep* under {args.out}")
        path = os.path.join(args.out, cks[-1])
        tr.restore_checkpoint(path)
        print(f"resumed from {path}: start_epoch={tr.start_epoch} "
              f"level={tr.level} step={tr.step}", file=sys.stderr)

    out = tr.fit()
    summary = {"best": out["best"], "best_epoch": out["best_epoch"],
               "epochs_run": len(out["history"]),
               "train_samples": len(train_ids), "val_samples": len(val_ids),
               "windows": args.windows, "resumed_from": tr.start_epoch
               if args.resume else 0,
               "wall_minutes": round((time.time() - t0) / 60, 1)}
    # summary.json holds the latest summary (valid JSON for json.load);
    # every invocation (the first and each resume) appends its own to
    # summary_history.jsonl.
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        f.write(json.dumps(summary) + "\n")
    with open(os.path.join(args.out, "summary_history.jsonl"), "a") as f:
        f.write(json.dumps(summary) + "\n")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
