"""Random weights from the run's seed, made on the model's device in one
draw, for the program's model and the reference alike.

The parameters are taken in the order of their sorted names, each the next
slice of one ``torch.randn`` from a generator on the device seeded with
the run's seed, and scaled by the initialiser of its kind: LeCun normal
(std ``1 / sqrt(fan_in)``, fan-in the product of a weight's dimensions
after the first) for the weights of dense and convolution layers, std 1
for embedding tables, ones for a 1-D ``weight`` (a norm's scale), zeros for
biases, 0.1 for ``res_scale`` and ``logspace(0, 2)`` for
``basis_freqs``: the flax initialisers the model family uses.  So one
seed gives both sides the same weights, whatever order they build their
modules in."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def fill(model: nn.Module, seed: int) -> nn.Module:
    embeddings = {id(m.weight) for m in model.modules()
                  if isinstance(m, nn.Embedding)}
    named = sorted(model.named_parameters(), key=lambda kv: kv[0])
    dev = named[0][1].device
    total = sum(p.numel() for _, p in named)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
    pos = 0
    for name, p in named:
        draw = flat[pos: pos + p.numel()].view(p.shape)
        pos += p.numel()
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "res_scale":
            p.fill_(0.1)
        elif leaf == "basis_freqs":
            p.copy_(torch.logspace(0.0, 2.0, p.numel(), device=dev))
        elif leaf == "bias":
            p.zero_()
        elif id(p) in embeddings:
            p.copy_(draw)
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            p.copy_(draw / math.sqrt(p[0].numel()))
    return model
