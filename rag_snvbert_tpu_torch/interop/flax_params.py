"""Load a flax parameter tree into the torch model, one leaf to one tensor.

The torch modules carry the flax tree's names (``bert/encoder/block_0/
attention/query``, ``hap_classifier/Dense_3``, ...), so a leaf's path is
its ``state_dict`` key once the leaf name is mapped.  Layout rules (as in
rag_snvbert_tpu/interop/torch_ckpt.py:52-72):

  Dense ``kernel [in, out]``      -> Linear ``weight [out, in]``
  Conv ``kernel [k, in, out]``    -> Conv1d ``weight [out, in, k]``
  LayerNorm/GroupNorm ``scale``   -> ``weight``
  FrozenBatchNorm ``scale``       -> ``weight`` (``mean``/``var`` buffers)
  Embed ``embedding``             -> Embedding ``weight``

Scalars (``res_scale``) stay scalars.  A tree of a ``scan_layers=True``
model keeps the encoder's blocks at ``encoder/blocks/...`` with a leading
``[n_layers]`` axis (flax ``nn.scan``); they are unstacked leaf by leaf
into ``encoder/block_{i}/...`` first.  A leftover or missing leaf raises.
``flax_params_of`` is the inverse: a port model (or its ``state_dict``) ->
the flax-layout numpy tree, by the same rules read backwards, so converted
reference checkpoints go into the port and back out through one set of
rules.

``load_optax_adam_state`` carries an optax Adam state (``mu``, ``nu``,
``count``, and the ``MultiSteps`` fields around it) into the port's
``train.schedule.Optimizer`` by the same rules, so one update can be held
against optax from the same state.  flax keeps ``FrozenBatchNorm``'s
``mean``/``var`` as stop-gradient parameters, so optax has moments for
them; the port keeps them as buffers, whose moments must be zeros.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _unstack_scanned(flat: dict[tuple, np.ndarray]
                     ) -> dict[tuple, np.ndarray]:
    """``(..., encoder, blocks, *rest)`` leaves of ``[n_layers, ...]`` ->
    ``(..., encoder, block_{i}, *rest)`` leaves, one a layer."""
    out = {}
    for path, arr in flat.items():
        at = [j for j in range(len(path) - 1)
              if path[j:j + 2] == ("encoder", "blocks")]
        if not at:
            out[path] = arr
            continue
        j = at[0]
        for i in range(arr.shape[0]):
            out[path[:j + 1] + (f"block_{i}",) + path[j + 2:]] = arr[i]
    return out


def _leaves(tree: Mapping) -> dict[tuple, np.ndarray]:
    return _unstack_scanned(_flatten(tree))


def _to_torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    if leaf == "kernel" and arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    return arr


def _torch_key(path: tuple) -> str:
    return ".".join(path[:-1] + (_RENAME.get(path[-1], path[-1]),))


def leaf_shapes(tree: Mapping) -> dict[str, tuple]:
    """``{"a/b/leaf": shape}`` of a flax-layout tree (scanned blocks
    unstacked)."""
    return {"/".join(p): tuple(v.shape) for p, v in _leaves(tree).items()}


def flax_params_of(model_or_state) -> dict:
    """The flax-layout numpy tree (float32) of a port model or of its
    ``state_dict``: the inverse of ``load_flax_params``.  A ``weight`` is
    an ``Embed``'s ``embedding``, a norm's ``scale`` (1-D) or a Dense/Conv
    ``kernel`` in the flax layout; buffers (``FrozenBatchNorm``'s
    ``mean``/``var``) are leaves, as they are parameters in flax."""
    state = (model_or_state.state_dict()
             if isinstance(model_or_state, nn.Module) else model_or_state)
    tree: dict = {}
    for key, val in state.items():
        *mods, leaf = key.split(".")
        arr = (val.detach().float().cpu().numpy()
               if isinstance(val, torch.Tensor) else np.asarray(val))
        if leaf == "weight":
            if mods[-1].startswith("Embed"):
                leaf = "embedding"
            elif arr.ndim == 1:
                leaf = "scale"
            else:
                leaf = "kernel"
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.array(arr, order="C")   # 0-d stays 0-d
    return tree


@torch.no_grad()
def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy every leaf of ``params`` (nested dicts of arrays, the flax
    ``params`` collection) into ``model``; raise on any leaf without a
    torch counterpart, any torch tensor without a leaf, or a shape
    mismatch."""
    state = model.state_dict()
    seen = set()
    extra = []
    for path, arr in _leaves(params).items():
        key = _torch_key(path)
        if key not in state:
            extra.append("/".join(path))
            continue
        val = np.array(_to_torch_layout(path[-1], arr), order="C")  # 0-d stays 0-d
        dst = state[key]
        if tuple(val.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(path)}: shape {val.shape} does not "
                             f"fit {key} {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(val).to(dst.dtype))
        seen.add(key)
    missing = sorted(set(state) - seen)
    if extra or missing:
        raise KeyError(f"flax/torch trees differ: leaves without a torch "
                       f"tensor {extra}; torch tensors without a leaf "
                       f"{missing}")
    return model


def _find(state, want: str):
    """Every node under an optax state (nested tuples of named tuples) that
    has field ``want``."""
    if want in getattr(state, "_fields", ()):
        return [state]
    if isinstance(state, tuple):
        return [n for sub in state for n in _find(sub, want)]
    return []


def _tree_into(optimizer, tree: Mapping, what: str,
               buffers: frozenset = frozenset()) -> dict:
    """A flax-layout tree of float32 leaves -> ``{parameter name: tensor}``
    for ``optimizer``'s parameters; raises on a leftover or missing leaf.
    Leaves of ``buffers`` (the model's buffer names) are skipped once they
    are checked to be zeros."""
    shapes = {n: tuple(p.shape) for n, p in zip(optimizer.names,
                                                 optimizer.params)}
    out, extra = {}, []
    for path, arr in _leaves(tree).items():
        name = _torch_key(path)
        if name in buffers and name not in shapes:
            if np.any(arr):
                raise ValueError(f"{what} {'/'.join(path)}: the port keeps "
                                 f"{name} as a buffer, without moments, but "
                                 "the optax state has non-zero ones")
            continue
        if name not in shapes:
            extra.append("/".join(path))
            continue
        val = np.array(_to_torch_layout(path[-1], arr), order="C")
        if tuple(val.shape) != shapes[name]:
            raise ValueError(f"{what} {'/'.join(path)}: shape {val.shape} "
                             f"does not fit {name}")
        out[name] = torch.from_numpy(val).float()
    missing = sorted(set(shapes) - set(out))
    if extra or missing:
        raise KeyError(f"{what}: leaves without a parameter {extra}; "
                       f"parameters without a leaf {missing}")
    return out


@torch.no_grad()
def load_optax_adam_state(optimizer, opt_state,
                          model: nn.Module | None = None) -> None:
    """Copy an optax state of ``make_optimizer``'s chain (clip -> adamw ->
    schedule, optionally inside ``MultiSteps``) into ``optimizer``:
    Adam's ``mu``/``nu`` by the layout rules above, its ``count`` (which
    must equal the schedule's), and ``mini_step``/``acc_grads`` of
    MultiSteps.  The optimizer's ``accum_steps`` must match the state.
    ``model``: the optimizer's model, whose buffers (``FrozenBatchNorm``'s
    ``mean``/``var``) have zero moments in the state and are skipped; a
    state with such leaves needs it."""
    multi = hasattr(opt_state, "mini_step")
    if multi != (optimizer.acc is not None):
        raise ValueError("optax state and optimizer disagree on gradient "
                         "accumulation (MultiSteps)")
    inner = opt_state.inner_opt_state if multi else opt_state
    adam = _find(inner, "mu")
    counts = {int(np.asarray(n.count)) for n in _find(inner, "count")}
    if len(adam) != 1 or len(counts) != 1:
        raise ValueError("expected one Adam state and one update count in "
                         f"the optax state, found {len(adam)} and {counts}")
    buffers = frozenset(() if model is None else
                        (name for name, _ in model.named_buffers()))
    optimizer.load_state_dict({
        "count": counts.pop(),
        "mini_step": int(np.asarray(opt_state.mini_step)) if multi else 0,
        "mu": _tree_into(optimizer, adam[0].mu, "mu", buffers),
        "nu": _tree_into(optimizer, adam[0].nu, "nu", buffers),
        "acc": (_tree_into(optimizer, opt_state.acc_grads, "acc", buffers)
                if multi else None)})
