"""Device-agnostic checkpoint restore.

The counterpart of rag_snvbert_tpu/utils/ckpt.py (``restore_tree``).  A
port checkpoint is a directory holding ``state.pt``: the trainer's
(``{params, opt_state, step, epoch, level, es_*}``, ``Trainer.
save_checkpoint``) or a converted reference checkpoint's (``{params}``,
``interop.save_converted``).  ``torch.load(map_location=...)`` puts every
tensor where this process wants it, whatever device wrote it (the
reference's resume path does the same).  Only tensors, numbers and
containers are read back (``weights_only=True``): nothing in the file is
executed.
"""

from __future__ import annotations

import os

import torch

STATE_NAME = "state.pt"


def restore_tree(path: str, map_location="cpu") -> dict:
    """The checkpoint dict of ``path`` (a checkpoint directory or its
    ``state.pt``) with its tensors on ``map_location``."""
    p = path if os.path.isfile(path) else os.path.join(path, STATE_NAME)
    if not os.path.exists(p):
        raise FileNotFoundError(f"{path!r} holds no {STATE_NAME} (a port "
                                "checkpoint directory is expected)")
    return torch.load(p, map_location=map_location, weights_only=True)
