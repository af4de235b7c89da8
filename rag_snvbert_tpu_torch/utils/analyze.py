"""Training-run analysis: metrics CSV / events.jsonl -> rows and plots.

The counterpart of rag_snvbert_tpu/utils/analyze.py without pandas (the
card's machine has none): tables are lists of dicts, one a row, with the
values ``pandas.read_csv`` would give (integers, floats, strings; an empty
cell is NaN).  It replaces the reference's regex log scraping
(scripts/analyze_training_log.py:14-302) -- the trainer writes structured
metrics.csv and events.jsonl, so parsing is a read -- and its CSV plotter
with rare/common panels (scripts/plot_metrics_csv.py:13-175).
"""

from __future__ import annotations

import csv
import json
import math
import os

import numpy as np


def _cell(text: str):
    if text == "":
        return math.nan
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def load_metrics_csv(path: str) -> list[dict]:
    with open(path, newline="", encoding="utf-8") as f:
        return [{k: _cell(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def load_events(path: str, event: str | None = None) -> list[dict]:
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if event is None or rec.get("event") == event:
                rows.append(rec)
    return rows


def epoch_summary(run_dir: str) -> list[dict]:
    """One row per epoch with train/val losses and F1 splits."""
    return load_metrics_csv(os.path.join(run_dir, "metrics.csv"))


def format_table(rows: list[dict], columns: list[str] | None = None) -> str:
    """Rows as right-aligned text columns (``DataFrame.to_string``'s
    layout, without the index)."""
    if not rows:
        return ""
    columns = columns or list(rows[0])

    def fmt(v):
        if isinstance(v, float):
            return f"{v:.6f}"
        return str(v)

    cells = [[fmt(r.get(c, "")) for c in columns] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells))
              for i, c in enumerate(columns)]
    lines = [" ".join(c.rjust(w) for c, w in zip(columns, widths))]
    lines += [" ".join(v.rjust(w) for v, w in zip(row, widths))
              for row in cells]
    return "\n".join(lines)


def plot_metrics(run_dir: str, out_path: str | None = None) -> str:
    """Loss + overall/rare/common F1 panels (plot_metrics_csv.py parity).
    Needs matplotlib; raises ImportError naming it where it is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_metrics needs matplotlib, which is not "
                          "installed here; analyze --no-plot prints the "
                          "table alone") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = epoch_summary(run_dir)
    cols = set(rows[0]) if rows else set()

    def series(col):
        return [r[col] for r in rows]

    epoch = series("epoch")
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    axes[0].plot(epoch, series("train_loss"), label="train")
    if "val_loss" in cols:
        axes[0].plot(epoch, series("val_loss"), label="val")
    axes[0].set_title("loss")
    axes[0].set_xlabel("epoch")
    axes[0].legend()
    for col, label in [("train_hap_f1", "train hap"), ("val_hap_f1", "val hap"),
                       ("val_gt_f1", "val gt")]:
        if col in cols:
            axes[1].plot(epoch, series(col), label=label)
    axes[1].set_title("F1")
    axes[1].set_xlabel("epoch")
    axes[1].legend()
    for col, label in [("val_rare_f1", "rare"), ("val_common_f1", "common")]:
        if col in cols:
            axes[2].plot(epoch, series(col), label=label)
    axes[2].set_title("rare vs common F1 (MAF @ 0.05)")
    axes[2].set_xlabel("epoch")
    axes[2].legend()
    fig.tight_layout()
    out = out_path or os.path.join(run_dir, "metrics.png")
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def compare_checkpoints(path_a: str, path_b: str, top: int = 10
                        ) -> list[dict]:
    """Per-parameter drift between two port checkpoints (the reference's
    debug_model_weights.py workflow): L2 norm of the delta and relative
    change, sorted descending."""
    from .ckpt import restore_tree

    a, b = restore_tree(path_a), restore_tree(path_b)
    pa, pb = a.get("params", a), b.get("params", b)
    rows = []
    for name, ta in pa.items():
        if name not in pb:
            continue
        xa = np.asarray(ta.detach().double().cpu().numpy())
        xb = np.asarray(pb[name].detach().double().cpu().numpy())
        if xa.shape != xb.shape:
            continue
        delta = float(np.linalg.norm(xb - xa))
        base = float(np.linalg.norm(xa))
        rows.append({"param": name, "shape": list(xa.shape),
                     "delta_l2": delta,
                     "rel_change": delta / max(base, 1e-12)})
    rows.sort(key=lambda r: -r["delta_l2"])
    return rows[:top] if top else rows


def inspect_freq(freq_path: str) -> dict:
    """Frequency-table audit (the reference's test_fq.py /
    test_input_freqnpy NaN checks): NaN/inf counts, layer consistency, AF
    range."""
    z = np.load(freq_path if freq_path.endswith(".npz")
                else freq_path + ".npz")
    f = z["freq"]
    return {
        "shape": list(f.shape),
        "nan_count": int(np.isnan(f).sum()),
        "inf_count": int(np.isinf(f).sum()),
        "af_min": float(np.nanmin(f[3])),
        "af_max": float(np.nanmax(f[3])),
        "gt_layers_sum_to_1": bool(
            np.allclose(f[0] + f[1] + f[2], 1.0, atol=1e-4)),
    }
