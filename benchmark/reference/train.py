"""Training steps: the loss's gradient, the clipped Adam update with the
warm-up + inverse-sqrt learning rate, and gradient accumulation.

Each micro-step: dropout from ``torch.Generator(device).manual_seed(
step_seed(seed, step))``; retrieval (its search without gradient), the
forward pass, the summed 3/3/4 focal loss, backward.  Every
``accum_steps`` micro-steps the mean of their gradients is clipped to
global norm 1.0 and updates Adam (b1 0.9, b2 0.999, eps 1e-8) with the
schedule's rate at the number of updates already applied, all float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import model as ref_model
from . import retrieval


def step_seed(seed: int, step: int) -> int:
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return int(state[0])


def learning_rate(update: int, init_lr, max_lr, warmup) -> float:
    """The schedule in float32: linear warm-up, then inverse sqrt."""
    f = np.float32
    s = f(update)
    if s <= warmup:
        return float(f((max_lr - init_lr) / warmup) * s + f(init_lr))
    return float(f(max_lr * warmup ** 0.5) * s ** f(-0.5))


class Adam:
    def __init__(self, params: dict, init_lr, max_lr, warmup, accum_steps,
                 clip=1.0, b1=0.9, b2=0.999, eps=1e-8):
        self.params = params
        self.sched = (init_lr, max_lr, warmup)
        self.accum, self.clip = accum_steps, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.acc = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0
        self.micro = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        n = self.micro
        for k, g in grads.items():
            self.acc[k] += (g - self.acc[k]) / (n + 1)
        self.micro += 1
        if self.micro < self.accum:
            return
        self.micro = 0
        lr = learning_rate(self.count, *self.sched)
        self.count += 1
        norm = math.sqrt(sum(float((g.double() ** 2).sum())
                             for g in self.acc.values()))
        scale = min(1.0, self.clip / norm) if norm > 0 else 1.0
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for k, p in self.params.items():
            g = self.acc[k] * scale
            self.mu[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            p -= lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                             + self.eps)
            self.acc[k].zero_()


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()
            if k != "window_mask"}


def micro_step(model, batch: dict, ctx, seed: int, step: int,
               rag_mode: str, device, keep_rows=None):
    """One micro-step's ``(loss, {name: gradient})``.  ``ctx``: the
    window's context (``retrieval.embedding_context``'s tuple, or
    ``(ref tokens, window mask, valid)`` in token mode).  ``keep_rows``
    (the fault "half of the batch left out") keeps those rows of the
    batch and scales the sum to the whole batch's size."""
    model.train()
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    ref_model.set_generator(model, gen)
    model.zero_grad(set_to_none=True)
    x = to_device(batch, device)
    scale = 1.0
    if keep_rows is not None:
        scale = x["hap_1"].shape[0] / len(keep_rows)
        x = {k: (v[keep_rows] if v.dim() > 1 else v) for k, v in x.items()}
    x = {k: (v.float() if v.is_floating_point() else v)
         for k, v in x.items()}
    if rag_mode == "token":
        x = retrieval.retrieve_tokens(x, *ctx)
    else:
        x = retrieval.retrieve_embedding(model, x, ctx)
    loss = ref_model.total_loss(model(x), x) * scale
    loss.backward()
    grads = {k: (p.grad.detach().clone() if p.grad is not None
                 else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    ref_model.set_generator(model, None)
    return float(loss.detach()), grads
