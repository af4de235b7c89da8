"""Layers with flax's numerics, and seeded initialisation.

flax and torch differ in defaults that change numbers: flax ``Dense`` and
``LayerNorm`` compute in their ``dtype`` (or in the promotion of input and
parameter types when it is ``None``) from float32 parameters; ``LayerNorm``
takes eps 1e-6 and normalises in float32.  These two classes carry those
rules so every module above them matches its flax twin.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _out_dtype(x: torch.Tensor, param: torch.Tensor,
               dtype: torch.dtype | None) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                               param.dtype)


class Dense(nn.Linear):
    """``flax.linen.Dense``: float32 parameters, computed in ``dtype``
    (``None``: the promotion of input and parameter types, as flax does).
    Weights are stored torch-style, ``[out, in]``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _out_dtype(x, self.weight, self.compute_dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: eps 1e-6, statistics in float32, output in
    ``dtype`` (``None``: promotion of input and float32)."""

    def __init__(self, dims: int, dtype: torch.dtype | None = None,
                 eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dims))
        self.bias = nn.Parameter(torch.zeros(dims))
        self.compute_dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight,
                         self.bias, self.eps)
        return y.to(_out_dtype(x, self.weight, self.compute_dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` is the tanh approximation (torch's default is erf)."""
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None,
            broadcast: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element with probability
    ``1 - rate`` and divide the kept ones by it, with the keep draws taken
    from ``gen`` (never torch's global RNG).  ``broadcast`` shares one mask
    along the sequence axis of ``[B, L, D]`` (the JAX package's
    ``dropout_broadcast``).  Raises without a generator."""
    if rate == 0.0:
        return x
    if gen is None:
        raise RuntimeError("dropout in train mode needs a generator: call "
                           "set_dropout_generator(model, generator) first")
    shape = (x.shape[0], 1, x.shape[2]) if broadcast else x.shape
    keep = torch.rand(shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class Dropout(nn.Module):
    """Dropout whose draws come from the generator that
    ``set_dropout_generator`` hands it; the identity in eval mode."""

    def __init__(self, rate: float, broadcast: bool = False):
        super().__init__()
        self.rate, self.broadcast = rate, broadcast
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return dropout(x, self.rate, self.generator, self.broadcast)


def set_dropout_generator(model: nn.Module,
                          gen: torch.Generator | None) -> None:
    """Give every ``Dropout`` of ``model`` the generator to draw from (one
    per training step: the trainer seeds it from the run seed and the
    step)."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = gen


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter from one seeded CPU generator (no global RNG).

    Dense and Conv kernels are LeCun-normal (flax's default), embeddings
    standard normal, norms one/zero, biases zero; the few named scalars
    take their flax initial values.  Serving smoke runs use these random
    weights; parity tests load flax weights instead (``interop``)."""
    g = torch.Generator().manual_seed(seed)

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float32) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d)):
            fan_in = mod.weight[0].numel()
            normal_(mod.weight, 1.0 / math.sqrt(fan_in))
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 1.0)
        elif isinstance(mod, (LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        for name, p in mod.named_parameters(recurse=False):
            if name == "res_scale":
                p.fill_(0.1)
            elif name == "basis_freqs":
                p.copy_(torch.logspace(0.0, 2.0, p.numel()))
        if hasattr(mod, "reset_stats"):
            mod.reset_stats()
    return model
