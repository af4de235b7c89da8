"""Multi-host input: each process keeps its local rows of a global batch.

Port of rag_snvbert_tpu/parallel/multihost.py (:23-33).  In JAX the local
rows are stitched into one global ``jax.Array``; here a rank's batch *is*
its local rows (every rank is a process), so ``global_batch`` moves them to
the rank's device and checks that the ranks of the ``data`` group agree on
every leaf's rows, which add up to the global batch.
``WindowDataset.epoch_batches(host_id=, n_hosts=)`` yields the rows of a
shared deterministic schedule.
"""

from __future__ import annotations

import numpy as np
import torch

from . import comm
from .mesh import DATA_AXIS, axis_group, axis_size


def global_batch(mesh, local_batch: dict, device=None) -> dict:
    """``local_batch`` (numpy or torch leaves, leading dim = this rank's
    rows) as tensors on ``device`` (``None``: the mesh's device type).
    Raises ``ValueError`` unless every rank of the data group holds the
    same number of rows of every leaf (so they add up to ``n x rows``)."""
    dev = torch.device(device if device is not None else mesh.device_type)
    out = {k: (v if isinstance(v, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(v))).to(dev)
           for k, v in local_batch.items()}
    if axis_size(mesh, DATA_AXIS) > 1:
        rows = torch.tensor([v.shape[0] for v in out.values()],
                            dtype=torch.int64, device=dev)
        every = comm.all_gather(rows, axis_group(mesh, DATA_AXIS))
        if not bool((every == rows[None, :]).all()):
            raise ValueError(f"ranks of the data axis hold different "
                             f"rows per leaf: {every.tolist()}")
    return out
