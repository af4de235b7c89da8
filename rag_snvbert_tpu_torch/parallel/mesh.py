"""The process world and its (data, index, model) mesh.

Port of rag_snvbert_tpu/parallel/mesh.py (:33-64).  JAX's mesh is one
controller driving every device; here every rank is a process (SPMD), and
the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
named ``("data", "index", "model")``:

  - ``data``: a global batch's rows are split over it; gradients and the
    metric counters are summed over its groups;
  - ``index``: the rows of a retrieval index or of a window's search
    context are split over it (``index/sharded.py``,
    ``train/sharded_retrieval.py``); candidates merge within its groups;
  - ``model``: Megatron tensor parallelism of the encoder
    (``parallel/tp.py``).

Ranks that share a ``data`` coordinate hold the same rows.  Rank 0 owns
files, logs, checkpoints and the front end.  The backend is explicit: NCCL
on the card by default, gloo when the caller names it (the CPU, or ranks
that share one card).  Collectives go through ``parallel/comm.py``.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
INDEX_AXIS = "index"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, INDEX_AXIS, MODEL_AXIS)
BACKENDS = ("nccl", "gloo")


def init_distributed(backend: str = "nccl", rank: int | None = None,
                     world_size: int | None = None,
                     init_method: str | None = None) -> bool:
    """Join the process group: with ``rank``/``world_size``/``init_method``
    given, those; else torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``).  Returns False when
    the process is already in a group (it must use ``backend``).  With
    NCCL, or gloo on the card, the rank's device is
    ``LOCAL_RANK`` (torchrun) or ``rank`` modulo the card count: ranks
    that share one card all take card 0."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs "
                             f"{dist.get_backend()}, not {backend}")
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if backend == "nccl" or torch.cuda.is_available():
        if backend == "nccl" and not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device; pass backend "
                               "'gloo' to run on the CPU")
        if torch.cuda.is_available():
            local = int(os.environ.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return True


def make_mesh(n_data: int | None = None, n_index: int = 1,
              n_model: int = 1, device: str | torch.device | None = None
              ) -> DeviceMesh:
    """The (data, index, model) mesh over every rank of the process group
    (rank = ((d * n_index) + i) * n_model + m, as JAX's device array is
    laid out).  ``n_data=None`` takes the ranks left over; the product
    must equal the world size.  ``device``: where the ranks' tensors live
    (``None``: the card).  Rank 0 prints the backend and the mesh shape to
    stderr when the world has more than one rank."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // (n_index * n_model)
    if n_data * n_index * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_index} x {n_model} does not "
                         f"cover the {world} ranks of the process group")
    dev = torch.device("cuda" if device is None else device)
    mesh = init_device_mesh(dev.type, (n_data, n_index, n_model),
                            mesh_dim_names=AXES)
    if world > 1 and dist.get_rank() == 0:
        print(f"mesh data={n_data} index={n_index} model={n_model} "
              f"backend={dist.get_backend()} world={world}",
              file=sys.stderr, flush=True)
    return mesh


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh or without the axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh: DeviceMesh | None, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's ``axis`` line."""
    return mesh.get_group(axis)


def is_writer() -> bool:
    """Rank 0 writes files, logs and checkpoints (every process outside a
    process group is its own rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def data_sharding(mesh: DeviceMesh | None, batch_size: int) -> slice:
    """This rank's rows of a global batch of ``batch_size`` rows
    (contiguous, ``batch_size / n_data`` each)."""
    n = axis_size(mesh, DATA_AXIS)
    if batch_size % n:
        raise ValueError(f"batch size {batch_size} does not divide over "
                         f"the {n} ranks of the data axis")
    per = batch_size // n
    lo = axis_rank(mesh, DATA_AXIS) * per
    return slice(lo, lo + per)


def shard_batch(batch: dict, mesh: DeviceMesh | None) -> dict:
    """This rank's rows of every leaf of a global batch."""
    return {k: v[data_sharding(mesh, v.shape[0])] for k, v in batch.items()}


def replicated(mesh: DeviceMesh | None, tensor: torch.Tensor,
               src: int = 0) -> torch.Tensor:
    """``tensor`` made equal on every rank: rank ``src``'s values,
    broadcast over the whole world (in place; returned)."""
    if mesh is not None and dist.get_world_size() > 1:
        dist.broadcast(tensor, src)
    return tensor


def index_row_sharding(mesh: DeviceMesh | None, n_rows: int
                       ) -> tuple[int, int, int]:
    """``(lo, hi, rows_per_shard)``: this rank's rows of an index of
    ``n_rows`` padded to ``rows_per_shard * n_shards`` (the padding rows
    are the last shards' tail, ``hi`` may pass ``n_rows``)."""
    n_shards = axis_size(mesh, INDEX_AXIS)
    per = -(-n_rows // n_shards)
    lo = axis_rank(mesh, INDEX_AXIS) * per
    return lo, lo + per, per
