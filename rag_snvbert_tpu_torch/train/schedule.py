"""LR schedule and the optimizer: global-norm clip -> Adam -> warmup +
inverse-sqrt LR, with optional gradient accumulation.

Port of rag_snvbert_tpu/train/schedule.py.  ``Optimizer`` reproduces the
optax chain of ``make_optimizer`` (:32-40) step for step, in float32:

  1. ``optax.clip_by_global_norm(c)``: ``g`` if ``|g| < c`` else
     ``g / |g| * c``, i.e. ``g * min(1, c / |g|)`` with no epsilon
     (``torch.nn.utils.clip_grad_norm_`` divides by ``|g| + 1e-6``);
  2. ``optax.adamw(schedule, b1=0.9, b2=0.999, eps=1e-8,
     weight_decay=0)``: bias-corrected moments, no weight decay (torch's
     ``AdamW`` would default to 0.01);
  3. the learning rate is the schedule at the number of updates already
     applied;
  4. ``accum_steps > 1`` is ``optax.MultiSteps``: the micro-gradients are
     averaged (its running-mean update), and every ``accum_steps``-th call
     clips the mean and updates once; the other calls leave the parameters
     as they are.  The mini-step counter and the running mean are part of
     the state.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


def warmup_inverse_sqrt(init_lr: float, max_lr: float,
                        warmup_steps: int) -> Callable[[int], float]:
    """Linear warmup ``init_lr -> max_lr``, then ``max_lr *
    sqrt(warmup / step)`` (ScheduledOptim._get_lr_scale,
    src/main/optim_schedule.py:33-46), computed in float32 as the JAX
    schedule is."""
    slope = np.float32((max_lr - init_lr) / warmup_steps)
    peak = np.float32(max_lr * warmup_steps ** 0.5)

    def schedule(step: int) -> float:
        s = np.float32(step)
        if s <= warmup_steps:
            return float(slope * s + np.float32(init_lr))
        return float(peak * s ** np.float32(-0.5))

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors, float32 (optax's
    ``global_norm``)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


class Optimizer:
    """The optax chain above over named float32 parameters.

    ``step()`` reads each parameter's ``.grad`` (a missing one counts as
    zeros) and returns whether it updated the parameters; ``count`` is the
    number of updates applied, ``mini_step`` the micro-steps accumulated
    towards the next one."""

    def __init__(self, named_params: Iterable[tuple[str, torch.Tensor]],
                 init_lr: float = 1e-5, max_lr: float = 7.5e-5,
                 warmup_steps: int = 15000, clip_norm: float = 1.0,
                 accum_steps: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.names, self.params = map(list, zip(*named_params))
        self.schedule = warmup_inverse_sqrt(init_lr, max_lr, warmup_steps)
        self.clip_norm, self.accum_steps = clip_norm, accum_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mini_step = 0

        def zeros():
            return [torch.zeros_like(p, dtype=torch.float32)
                    for p in self.params]

        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if accum_steps > 1 else None
        self.last_lr = float("nan")

    def grads(self) -> list[torch.Tensor]:
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        grads = self.grads()
        if self.acc is not None:
            n = self.mini_step
            # acc + (g - acc) / (n + 1), a float32 operation at a time
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, self._scalar(n + 1))
            torch._foreach_add_(self.acc, delta)
            if n < self.accum_steps - 1:
                self.mini_step = n + 1
                return False
            grads = self.acc
        self._update(grads)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
        return True

    def _scalar(self, value: float) -> torch.Tensor:
        """``value`` as a 0-d float32 tensor on the parameters' device, made
        by a fill (no copy from the host, so no wait for the stream)."""
        return torch.full((), value, dtype=torch.float32,
                          device=self.params[0].device)

    def _update(self, grads: list[torch.Tensor]) -> None:
        """One clipped Adam update, each step one float32 operation over
        every tensor (``torch._foreach_*``: a few launches an update where
        a loop over the tensors makes ~20 each), in optax's order:
        ``g / |g| * c``, ``(1 - b1) g + b1 mu``, ``(1 - b2) g^2 + b2 nu``,
        ``p - lr (mu / bc1) / (sqrt(nu / bc2) + eps)``.  Every divisor here
        and in the accumulation is a 0-d float32 tensor on the parameters'
        device, so the division is a true one as on the CPU: CUDA divides
        by a Python scalar as a product with its reciprocal, which rounds
        differently.  The clip branch is chosen on the device: below the
        limit the gradients are divided and multiplied by 1, which leaves
        them as they are, so nothing is read back to the host."""
        norm = global_norm(grads)
        self.last_lr = self.schedule(self.count)
        self.count += 1
        f32 = dict(dtype=torch.float32)
        bc1 = self._scalar((1 - torch.tensor(self.b1, **f32)
                            ** self.count).item())
        bc2 = self._scalar((1 - torch.tensor(self.b2, **f32)
                            ** self.count).item())
        below, one = norm < self.clip_norm, self._scalar(1.0)
        grads = torch._foreach_mul(
            torch._foreach_div(grads, torch.where(below, one, norm)),
            torch.where(below, one, self._scalar(self.clip_norm)))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - self.b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - self.b2))
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_add_(self.params, torch._foreach_mul(u, -self.last_lr))

    def state_dict(self) -> dict:
        def named(ts):
            return None if ts is None else dict(zip(self.names, ts))

        return {"count": self.count, "mini_step": self.mini_step,
                "mu": named(self.mu), "nu": named(self.nu),
                "acc": named(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("optimizer state and accum_steps disagree on "
                             "gradient accumulation")
        for key in ("mu", "nu", "acc"):
            if state[key] is None:
                continue
            if set(state[key]) != set(self.names):
                raise KeyError(f"optimizer state {key!r} names differ from "
                               "the parameters'")
            for name, dst in zip(self.names, getattr(self, key)):
                dst.copy_(state[key][name])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])


def make_optimizer(model: torch.nn.Module, init_lr: float = 1e-5,
                   max_lr: float = 7.5e-5, warmup_steps: int = 15000,
                   clip_norm: float = 1.0, accum_steps: int = 1
                   ) -> Optimizer:
    """The optimizer of the JAX ``make_optimizer`` over ``model``'s
    parameters: clip 1.0 -> Adam -> warmup + inverse-sqrt LR
    (pretrain_with_val_optimized.py:73-81, 233-245), MultiSteps when
    ``accum_steps > 1``."""
    return Optimizer(model.named_parameters(), init_lr, max_lr,
                     warmup_steps, clip_norm, accum_steps)
