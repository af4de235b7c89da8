"""Kernels written by hand for Hopper (``csrc/``), their wrappers and plain
versions.

Each wrapper counts its kernel launches in a plain integer attribute
(``attention.launches``, ``attention_bwd.launches``, ``l2_topk.launches``,
``l2_topk_rf.launches``, ``l2_topk_float.launches``), so a run can show
that the main path went through the kernels.
"""

from .attention import attention, attention_bwd
from .l2_topk import l2_topk
from .l2_topk_float import l2_topk_float
from .l2_topk_rf import l2_topk_rf

WRAPPERS = {"attention": attention, "attention_bwd": attention_bwd,
            "l2_topk": l2_topk, "l2_topk_rf": l2_topk_rf,
            "l2_topk_float": l2_topk_float}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
