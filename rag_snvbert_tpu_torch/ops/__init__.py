"""Kernels written by hand for Hopper (``csrc/``), their wrappers and plain
versions.

Each wrapper counts its kernel launches in a plain integer attribute
(``attention.launches``, ``l2_topk.launches``), so a run can show that the
main path went through the kernels.
"""

from .attention import attention
from .l2_topk import l2_topk

WRAPPERS = {"attention": attention, "l2_topk": l2_topk}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
