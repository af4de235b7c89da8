"""Flagship-scale compat-vs-fixed A/B of the port on the card.

The port of tools/ab_compat.py: the same same-panel, same-seed A/B at the
flagship geometry (``tpu_default``: 384d/12L, L=1030, bf16) on a synthetic
structured panel large enough for real retrieval, with a held-out
validation split of the single cohort, the same variants, flags, trainer
settings and JSON rows, so a run here sits beside the JAX tool's TPU table
(DESIGN.md section 10).

Variants:
  fixed    : tpu_default (pre-LN, logits heads, attn_dropout=0,
             sequence-broadcast residual dropout; the attention kernels)
  perdim   : fixed but per-element residual dropout (isolates the
             broadcast-mask perf knob's quality cost)
  compat   : reference topology (post-LN, double-softmax heads,
             attention-prob dropout, per-element dropout; attention
             dropout takes the einsum path, not the kernels)

Every training and validation step searches the window's 2048-row
context with ``l2_topk``.  The model trains on the card unless
``--device cpu`` is given.

Usage:
    python -m rag_snvbert_tpu_torch.tools.ab_compat [--epochs 14] \
        [--variants fixed,compat]
Prints the card's name and power limit, then one JSON line per variant;
the table goes into PERF.md.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

VARIANTS = {
    "fixed": {},
    "perdim": {"dropout_broadcast": False},
    "compat": {"pre_ln": False, "compat_double_softmax": True,
               "attn_dropout": None, "dropout_broadcast": False},
}
PRESET = "tpu_default"
SEED = 42          # the trainer's seed, and the weights' (as JAX draws them)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=14)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--train-samples", type=int, default=192)
    ap.add_argument("--ref-samples", type=int, default=1024)
    ap.add_argument("--val-frac", type=float, default=0.25)
    ap.add_argument("--variants", default="fixed,perdim,compat")
    ap.add_argument("--outdir", default="runs/ab_compat")
    ap.add_argument("--flash", default=None,
                    help="flash_attention override for ALL variants "
                         "(e.g. splash:384f); default = preset value")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' to run off the card")
    return ap


def build_panel(args, seq_len: int | None = None):
    """``(bundle, dataset)``: the JAX tool's panel (``make_bundle``, seed
    7) of ``args.windows`` windows of ``seq_len - 10`` sites."""
    from ..config import PRESETS
    from ..data.pipeline import WindowDataset
    from ..io.synthetic import make_bundle

    seq_len = seq_len or PRESETS[PRESET].model.seq_len
    win = seq_len - 10
    print(f"panel: {args.windows} windows x {win} sites, "
          f"{args.train_samples} train / {args.ref_samples} ref samples",
          file=sys.stderr)
    b = make_bundle(n_train_samples=args.train_samples,
                    n_ref_samples=args.ref_samples,
                    n_sites=args.windows * win, n_windows=args.windows,
                    seed=7)
    ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                       b.vocab, ref_vcf=b.ref, seq_len=seq_len)
    return b, ds


def split_ids(n: int, frac: float) -> tuple[np.ndarray, np.ndarray]:
    """``(train_ids, val_ids)``: the first ``int(n * frac)`` samples
    validate (stratified by construction: samples cycle over pops)."""
    ids = np.arange(n)
    n_val = int(n * frac)
    return ids[n_val:], ids[:n_val]


def variant_run(run, name: str, flash=None):
    """``run`` with the variant's model fields (and ``--flash``)."""
    m = dataclasses.replace(run.model, **VARIANTS[name])
    if flash is not None:
        m = dataclasses.replace(m, flash_attention=flash)
    return dataclasses.replace(run, model=m)


def trainer_config(run, args, name: str):
    """The JAX tool's ``TrainerConfig``, field for field."""
    from ..train.trainer import TrainerConfig

    return TrainerConfig(
        epochs=args.epochs, batch_size=run.batch_size,
        val_batch_size=run.val_batch_size, init_lr=run.init_lr,
        max_lr=run.max_lr, warmup_steps=60,
        grad_accum_steps=1, focal_gamma=run.focal_gamma,
        rag_k=run.rag_k, ref_pad_haps=2048, curriculum_every=2,
        patience=args.epochs,  # no early stop: full identical budget
        output_dir=f"{args.outdir}/{name}", log_freq=10_000, seed=SEED)


def run_variant(run, ds, ids, args, name: str) -> dict:
    """Train variant ``name`` of ``run`` on ``ds`` with ``ids = (train_ids,
    val_ids)`` for ``args.epochs`` epochs: the variant's JSON row."""
    from ..config import build_model
    from ..device import resolve_device
    from ..train.trainer import Trainer

    vrun = variant_run(run, name, args.flash)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(vrun, ds.vocab.size, device=device, seed=SEED)
    t0 = time.time()
    tr = Trainer(model, ds, trainer_config(vrun, args, name),
                 train_sample_ids=ids[0], val_sample_ids=ids[1])
    hist = tr.fit()["history"]
    if device.type == "cuda":
        print(f"{name}: peak allocated "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB",
              file=sys.stderr, flush=True)
    best = max(hist, key=lambda r: r["val_hap_f1"])
    return {"variant": name, "epochs": len(hist),
            "best_val_hap_f1": round(best["val_hap_f1"], 4),
            "best_epoch": best["epoch"],
            "final_val_hap_f1": round(hist[-1]["val_hap_f1"], 4),
            "final_val_rare_f1": round(hist[-1].get("val_rare_f1",
                                                    float("nan")), 4),
            "final_train_loss": round(hist[-1]["train_loss"], 4),
            "wall_min": round((time.time() - t0) / 60, 1)}


def main(argv=None) -> list[dict]:
    from ..config import PRESETS
    from ..device import card_line, resolve_device

    args = build_parser().parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        print(card_line(), flush=True)
    run = PRESETS[PRESET]
    _, ds = build_panel(args, run.model.seq_len)
    ids = split_ids(args.train_samples, args.val_frac)
    rows = []
    for name in args.variants.split(","):
        rows.append(run_variant(run, ds, ids, args, name))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
