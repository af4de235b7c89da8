"""Device metric counters: masked accuracy, per-class TP/FP/FN, rare/common
splits, F1 assembly.

Port of rag_snvbert_tpu/train/metrics.py (:23-125).  The counters are small
int64 tensors computed on the device every step and summed there across
the epoch (in place, ``accumulate_``); the trainer copies them to the host
once per epoch.

Reference parity: cal_acc (optim_schedule.py:99-109), cal_pr (:167-204),
rare/common split at MAF < 0.05 (pretrain_with_val_optimized.py:281-310),
F1 assembly (:362-422).
"""

from __future__ import annotations

import numpy as np
import torch

RARE_MAF_THRESHOLD = 0.05


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(correct_count, total_count) over mask==1 positions."""
    pred = torch.argmax(logits, dim=-1)
    m = mask.long()
    return torch.sum((pred == labels).long() * m), torch.sum(m)


def class_counts(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, num_classes: int
                 ) -> dict[str, torch.Tensor]:
    """Per-class {tp, fp, fn} int64 [C] counters over mask==1 positions."""
    pred = torch.argmax(logits, dim=-1)
    m = mask.bool()[..., None]
    classes = torch.arange(num_classes, device=logits.device)
    pred_oh = (pred[..., None] == classes) & m
    label_oh = (labels[..., None] == classes) & m
    dims = tuple(range(pred.dim()))
    return {"tp": torch.sum(pred_oh & label_oh, dim=dims),
            "fp": torch.sum(pred_oh & ~label_oh, dim=dims),
            "fn": torch.sum(~pred_oh & label_oh, dim=dims)}


def batch_counters(outputs: list, labels: dict, mask: torch.Tensor,
                   af: torch.Tensor,
                   rare_threshold: float = RARE_MAF_THRESHOLD) -> dict:
    """All per-batch counters in one dict of device tensors.  hap counters
    sum both haplotypes (as the reference does); the rare/common split uses
    MAF = min(af, 1-af) against ``rare_threshold``."""
    maf = torch.minimum(af, 1.0 - af)
    rare_mask = (maf < rare_threshold) & mask.bool()
    common_mask = (maf >= rare_threshold) & mask.bool()

    def both_haps(fn, m):
        return accumulate(fn(outputs[0], labels["hap_1"], m),
                          fn(outputs[1], labels["hap_2"], m))

    hap_acc = both_haps(lambda o, lab, m: masked_accuracy(o, lab, m)[0], mask)
    gt_acc, gt_tot = masked_accuracy(outputs[2], labels["gt"], mask)
    return {
        "hap": both_haps(lambda o, lab, m: class_counts(o, lab, m, 2), mask),
        "gt": class_counts(outputs[2], labels["gt"], mask, 4),
        "rare": both_haps(lambda o, lab, m: class_counts(o, lab, m, 2),
                          rare_mask),
        "common": both_haps(lambda o, lab, m: class_counts(o, lab, m, 2),
                            common_mask),
        "hap_correct": hap_acc,
        "hap_total": 2 * gt_tot,
        "gt_correct": gt_acc,
        "gt_total": gt_tot,
    }


def zeros_like_counters(device=None) -> dict:
    """An epoch accumulator of zeros, every leaf its own tensor."""
    def z(n=None):
        return torch.zeros(() if n is None else n, dtype=torch.int64,
                           device=device)

    def cls(n):
        return {"tp": z(n), "fp": z(n), "fn": z(n)}

    return {"hap": cls(2), "gt": cls(4), "rare": cls(2), "common": cls(2),
            "hap_correct": z(), "hap_total": z(), "gt_correct": z(),
            "gt_total": z()}


def accumulate(a, b):
    """Leaf-wise sum of two counter trees (dicts of tensors)."""
    if isinstance(a, dict):
        return {k: accumulate(a[k], b[k]) for k in a}
    return a + b


def accumulate_(a: dict, b: dict) -> dict:
    """Add counter tree ``b`` into ``a`` leaf by leaf, in place (the epoch
    accumulator's tensors keep their storage, as a CUDA graph that adds
    into them needs); returns ``a``."""
    for k, v in a.items():
        if isinstance(v, dict):
            accumulate_(v, b[k])
        else:
            v.add_(b[k])
    return a


# ---- host-side assembly (runs once per epoch) ----

def f1_from_counts(counts: dict) -> float:
    """Macro F1 over classes from {tp, fp, fn} arrays (the reference's
    per-class precision/recall averaged, pretrain_with_val_optimized.py:
    362-422)."""
    tp = np.asarray(counts["tp"], dtype=np.float64)
    fp = np.asarray(counts["fp"], dtype=np.float64)
    fn = np.asarray(counts["fn"], dtype=np.float64)
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / np.maximum(tp + fn, 1)
    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-12)
    return float(f1.mean())


def summarize(counters: dict) -> dict[str, float]:
    """Epoch summary scalars from accumulated host counters."""
    def ratio(a, b):
        return float(np.asarray(a)) / max(float(np.asarray(b)), 1.0)

    return {
        "hap_acc": ratio(counters["hap_correct"], counters["hap_total"]),
        "gt_acc": ratio(counters["gt_correct"], counters["gt_total"]),
        "hap_f1": f1_from_counts(counters["hap"]),
        "gt_f1": f1_from_counts(counters["gt"]),
        "rare_f1": f1_from_counts(counters["rare"]),
        "common_f1": f1_from_counts(counters["common"]),
    }
