"""Tensor parallelism of the encoder (Megatron), over the mesh's ``model``
axis.

Port of rag_snvbert_tpu/parallel/tp.py (:48-117).  The JAX package places
parameters with ``model``-axis shardings and lets GSPMD insert the
collectives; here ``shard_model`` keeps each rank's slices of the encoder's
parameters and the modules run the collectives themselves
(``models/transformer.py``, ``models/layers.py``).  The placement rules are
the JAX package's, over the port's parameter names (the flax tree's,
``interop/flax_params.py``), in torch's ``[out, in]`` layout:

  - attention ``query``/``key``/``value`` (or fused ``qkv``) and FFN
    ``w_1``: column-parallel, ``weight`` dim 0 and ``bias`` split (a fused
    ``qkv`` is split per Q, K and V third, not in contiguous thirds);
  - attention ``output`` and FFN ``w_2``: row-parallel, ``weight`` dim 1
    split, the partial products summed over the group before the
    (replicated) bias;
  - the FFN's internal LayerNorm normalizes the split hidden dim: its
    ``weight``/``bias`` are split and its statistics summed over the
    group;
  - everything else (embeddings, fusion, heads, the blocks' LayerNorms
    over D) is replicated.

How a rank computes with its slices:

  - where ``n_model`` divides ``attn_heads`` a rank's columns are whole
    heads and it runs attention on them alone;
  - where it does not (``tpu_default``'s 3 heads at tp2 or tp4), a rank's
    columns split a head: it all-gathers the group's q, k and v columns,
    runs attention (the CUDA kernel on the card) on the whole heads its
    columns touch, and keeps its own columns of the context; two ranks
    that share a head draw the same attention-dropout mask for it, and
    the gather's backward sums the head's gradient over them;
  - an ``int8_matmuls`` model's ``Int8Dense`` layers run their own
    collectives (``ops/quant.py``): scales along a split axis are the
    group's max and split integer contractions are summed in int32
    before the rescale.

Adam's moments are made from the parameters after ``shard_model``, so they
are split like them.  A checkpoint holds full tensors: ``gather_full``
before a save, ``shard_full`` after a load.  ``shard_model`` raises only
where the JAX package's ``tp_shardings`` does: where ``n_model`` does not
divide a split parameter dimension.
"""

from __future__ import annotations

import torch
from torch import nn

from . import comm
from .mesh import MODEL_AXIS, axis_group, axis_rank, axis_size

_COL_OWNERS = ("query", "key", "value", "qkv", "w_1")
_ROW_OWNERS = ("output", "w_2")


def spec_for_name(name: str, ndim: int) -> tuple:
    """The placement of one parameter (its ``state_dict`` name): a tuple
    over its torch dims, ``"model"`` on the split one, else ``None``
    (JAX ``spec_for_path`` with the kernel's dims reversed)."""
    parts = name.split(".")
    rep = (None,) * ndim
    if len(parts) < 2:
        return rep
    owner, param = parts[-2], parts[-1]
    enc = "encoder" in parts or any(p.startswith("block_") for p in parts)
    if not enc:
        return rep
    if owner in _COL_OWNERS:
        # weight [out, in] split over out; bias [out] follows
        return (MODEL_AXIS,) + (None,) * (ndim - 1)
    if owner in _ROW_OWNERS:
        if param == "weight" and ndim >= 2:
            return (None,) * (ndim - 1) + (MODEL_AXIS,)
        return rep           # the row layer's bias is added after the sum
    if param in ("weight", "bias") and "feed_forward" in parts:
        # the FFN-internal LayerNorm normalizes over the split hidden dim
        return (None,) * (ndim - 1) + (MODEL_AXIS,)
    return rep


def _split_dim(name: str, ndim: int) -> int | None:
    spec = spec_for_name(name, ndim)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _is_qkv(name: str) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "qkv"


def shard_tensor(name: str, full: torch.Tensor, rank: int, n: int
                 ) -> torch.Tensor:
    """Rank ``rank``'s slice of the full tensor ``name`` (a copy)."""
    dim = _split_dim(name, full.dim())
    if dim is None or n == 1:
        return full
    if _is_qkv(name):
        return torch.cat([p.chunk(n, dim)[rank] for p in full.chunk(3, dim)],
                         dim).clone()
    return full.chunk(n, dim)[rank].clone()


def gather_tensor(name: str, local: torch.Tensor, group, n: int
                  ) -> torch.Tensor:
    """The full tensor ``name`` from every rank's slice (a collective)."""
    dim = _split_dim(name, local.dim())
    if dim is None or n == 1:
        return local
    parts = list(comm.all_gather(local.detach(), group))
    if _is_qkv(name):
        thirds = [p.chunk(3, dim) for p in parts]
        return torch.cat([torch.cat([t[j] for t in thirds], dim)
                          for j in range(3)], dim)
    return torch.cat(parts, dim)


def gather_full(named: dict, mesh) -> dict:
    """``{name: full tensor}`` of a rank's ``{name: slice}`` (parameters,
    or Adam's moments under the parameters' names); the same on every rank
    of the group."""
    n = axis_size(mesh, MODEL_AXIS)
    if n == 1:
        return named
    group = axis_group(mesh, MODEL_AXIS)
    return {k: gather_tensor(k, v, group, n) if torch.is_tensor(v) else v
            for k, v in named.items()}


def shard_full(named: dict, mesh) -> dict:
    """This rank's slices of ``{name: full tensor}``."""
    n, r = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    if n == 1:
        return named
    return {k: shard_tensor(k, v, r, n) if torch.is_tensor(v) else v
            for k, v in named.items()}


def _validate(model: nn.Module, n: int) -> None:
    bad = []
    for name, p in model.named_parameters():
        dim = _split_dim(name, p.dim())
        if dim is not None and p.shape[dim] % n:
            bad.append((name, tuple(p.shape), dim))
    if bad:
        raise ValueError(f"model axis {n} does not divide these params "
                         f"(pick dims/ffn divisible by n_model): {bad[:4]}")


@torch.no_grad()
def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Keep this rank's slices of ``model``'s encoder parameters and make
    its attention, FFN and ``Int8Dense`` modules run the group's
    collectives (in place; returned).  A no-op for a model axis of 1.
    Raises ``ValueError`` when the axis does not divide a split
    dimension."""
    from ..models.transformer import FeedForward, MultiHeadAttention
    from ..ops.quant import Int8Dense

    n = axis_size(mesh, MODEL_AXIS)
    if n == 1:
        return model
    _validate(model, n)
    r, group = axis_rank(mesh, MODEL_AXIS), axis_group(mesh, MODEL_AXIS)
    for name, p in model.named_parameters():
        p.data = shard_tensor(name, p.data, r, n)
    for name, mod in model.named_modules():
        if isinstance(mod, MultiHeadAttention):
            hd, cols = mod.dims // mod.heads, mod.dims // n
            lo = r * cols
            h0, h1 = lo // hd, -(-(lo + cols) // hd)   # the heads it touches
            mod.tp_group = group
            mod.local_heads = h1 - h0
            mod.head_split = (None if mod.heads % n == 0
                              else (h0, lo - h0 * hd, cols))
            mod.attn_drop.heads = (h0, h1, mod.heads)
        elif isinstance(mod, FeedForward):
            mod.tp_group = group
            mod.LayerNorm_0.tp_group = group
        elif isinstance(mod, Int8Dense):
            spec = _split_dim(name + ".weight", 2)
            if spec is not None:
                mod.tp = ("column" if spec == 0 else "row", group)
    return model


def sharded_flags(model: nn.Module) -> list[bool]:
    """Per parameter (``named_parameters`` order): whether it is split
    over the model axis (the optimizer's clip norm adds those over the
    group and the replicated ones once)."""
    return [_split_dim(name, p.dim()) is not None
            for name, p in model.named_parameters()]
