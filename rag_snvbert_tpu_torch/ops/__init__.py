"""Kernels written by hand for Hopper (``csrc/``), their wrappers and plain
versions.

Attention routes by what it sees (``models/transformer.py``): float32
CUDA q, k and v with head dim 32, float32 scores and no mask take
the float32 kernels with the attention dropout inside
(``attention_f32``, ``attention_f32_bwd``); otherwise ``flash_attention``
with attention dropout 0 and no mask takes the bf16 kernels
(``attention``, ``attention_bwd``); the rest the einsum path.

Each wrapper counts its kernel launches in a plain integer attribute
(``attention.launches``, ``attention_bwd.launches``,
``attention_f32.launches``, ``attention_f32_bwd.launches``,
``layer_norm.launches``, ``layer_norm_bwd.launches``,
``residual.launches``, ``residual_bwd.launches``, ``l2_topk.launches``,
``l2_topk_rf.launches``, ``l2_topk_float.launches``,
``int8_probe.launches``, ``int8_probe.pack_int4.launches``), so a run
can show that the main path went through the kernels.  ``launch_counts()``
reads the model and index paths' kernels; ``launch_counts(tools=True)``
adds the int8 probe and its int4 pack, which only the probe tools
(``tools/probe_mxu*.py``) launch.
"""

from .attention import attention, attention_bwd
from .attention_f32 import attention_f32, attention_f32_bwd
from .layer_norm import layer_norm, layer_norm_bwd
from .residual import residual, residual_bwd
from .l2_topk import l2_topk
from .l2_topk_float import l2_topk_float
from . import int8_probe as _int8_probe   # ops.int8_probe: the module
from .l2_topk_rf import l2_topk_rf

WRAPPERS = {"attention": attention, "attention_bwd": attention_bwd,
            "attention_f32": attention_f32,
            "attention_f32_bwd": attention_f32_bwd,
            "layer_norm": layer_norm, "layer_norm_bwd": layer_norm_bwd,
            "residual": residual, "residual_bwd": residual_bwd,
            "l2_topk": l2_topk, "l2_topk_rf": l2_topk_rf,
            "l2_topk_float": l2_topk_float}
TOOL_WRAPPERS = {"int8_probe": _int8_probe.int8_probe,
                 "int8_probe_pack_int4": _int8_probe.pack_int4}


def launch_counts(tools: bool = False) -> dict[str, int]:
    wrappers = {**WRAPPERS, **TOOL_WRAPPERS} if tools else WRAPPERS
    return {name: fn.launches for name, fn in wrappers.items()}


def reset_launches() -> None:
    for fn in (*WRAPPERS.values(), *TOOL_WRAPPERS.values()):
        fn.launches = 0
