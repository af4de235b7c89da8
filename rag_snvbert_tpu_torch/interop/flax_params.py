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

Scalars (``res_scale``) stay scalars.  A leftover or missing leaf raises.
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


def _to_torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    if leaf == "kernel" and arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    return arr


@torch.no_grad()
def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy every leaf of ``params`` (nested dicts of arrays, the flax
    ``params`` collection) into ``model``; raise on any leaf without a
    torch counterpart, any torch tensor without a leaf, or a shape
    mismatch."""
    state = model.state_dict()
    seen = set()
    extra = []
    for path, arr in _flatten(params).items():
        key = ".".join(path[:-1] + (_RENAME.get(path[-1], path[-1]),))
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
