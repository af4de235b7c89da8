"""Losses: focal loss, masked reconstruction MSE, combined objective.

Port of rag_snvbert_tpu/train/losses.py (:22-83).  Reference parity:
FocalLoss (src/main/optim_schedule.py:49-96) — softmax, one-hot,
``-(1-p_t)^gamma * log(p_t + 1e-10)``, sum reduction as used by the trainer
(pretrain_with_val_optimized.py:87-88).  Every loss is a masked sum over
``[B, L]`` with an explicit mask (multiply-by-mask + sum), as in the JAX
package.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor, gamma: float = 2.0,
               alpha: torch.Tensor | None = None) -> torch.Tensor:
    """Masked-sum focal loss over ``logits [B, L, C]`` (probabilities are
    softmaxed like any other input, matching the reference), int
    ``targets [B, L]`` and ``mask [B, L]`` (1 = contributes); ``alpha``
    optional ``[C]`` class weights."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    p = torch.exp(logp)
    tgt = F.one_hot(targets.long(), logits.shape[-1]).float()
    p_t = torch.sum(p * tgt, dim=-1)
    loss = -((1.0 - p_t) ** gamma) * torch.log(p_t + 1e-10)
    if alpha is not None:
        loss = loss * torch.sum(alpha * tgt, dim=-1)
    return torch.sum(loss * mask.float())


def masked_mse(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
               count: torch.Tensor | None = None) -> torch.Tensor:
    """Reconstruction MSE over masked positions (mean over contributing
    elements), matching nn.MSELoss on ``output[3][masks]``
    (pretrain_with_val_optimized.py:221-222).  ``count``: the number of
    contributing positions when ``mask`` is one rank's share of a larger
    batch (the mean is then this share's part of the whole batch's)."""
    m = mask.float()[..., None]
    diff = (a.float() - b.float()) ** 2
    n = torch.sum(m) if count is None else count
    denom = torch.clamp(n * a.shape[-1], min=1.0)
    return torch.sum(diff * m) / denom


# Loss weights (pretrain_with_val_optimized.py:228-231).
HAP_WEIGHT = 3.0
GT_WEIGHT = 4.0
# Recon-mode weights, gated by MIN_RECON_LOSS (:224-226).
RECON_WEIGHTS = (0.2, 0.2, 0.3, 0.15, 0.15)
MIN_RECON_LOSS = 0.01


def total_loss(outputs: list, labels: dict, mask: torch.Tensor,
               gamma: float = 2.0, use_recon: bool = False,
               data_sum: Callable[[torch.Tensor], torch.Tensor] | None = None
               ) -> tuple[torch.Tensor, dict]:
    """Combined training loss: 3*hap1 + 3*hap2 + 4*gt focal, with the
    optional recon-gated variant (pretrain_with_val_optimized.py:215-231).

    ``data_sum`` (data parallelism: a detached sum over the data ranks)
    makes the return this rank's share of the global batch's loss, so the
    shares add up to it: the focal terms are masked sums already; the
    reconstruction means take the global count of masked positions, and
    the gate compares the global reconstruction losses."""
    hap1 = focal_loss(outputs[0], labels["hap_1"], mask, gamma)
    hap2 = focal_loss(outputs[1], labels["hap_2"], mask, gamma)
    gt = focal_loss(outputs[2], labels["gt"], mask, gamma)
    aux = {"hap_loss": hap1 + hap2, "gt_loss": gt}
    plain_total = HAP_WEIGHT * (hap1 + hap2) + GT_WEIGHT * gt
    if not use_recon:
        return plain_total, aux
    count = None if data_sum is None else data_sum(mask.float().sum())
    r1 = masked_mse(outputs[3], outputs[5], mask, count)
    r2 = masked_mse(outputs[4], outputs[6], mask, count)
    aux["recon_loss"] = r1 + r2
    w = RECON_WEIGHTS
    recon_total = (w[0] * hap1 + w[1] * hap2 + w[2] * gt
                   + w[3] * r1 + w[4] * r2)
    g1, g2 = (r1, r2) if data_sum is None else (data_sum(r1), data_sum(r2))
    use_gated = (g1 > MIN_RECON_LOSS) & (g2 > MIN_RECON_LOSS)
    return torch.where(use_gated, recon_total, plain_total), aux
