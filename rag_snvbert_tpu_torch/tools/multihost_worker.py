"""One rank of the multi-host input check: iterate the shared deterministic
schedule and write checksums of every global batch, computed with a
collective over the ranks' local rows.

Port of tools/multihost_worker.py.  Each process is one "host" of a gloo
world on the CPU: it iterates ``WindowDataset.epoch_batches(host_id=,
n_hosts=)``, takes its rows through ``parallel.multihost.global_batch``,
and sums every leaf, plain and weighted by the row's global index (1 +
row), over the ``data`` group: order-sensitive checksums of the global
batch that every rank holds after the ``all_reduce``.
``tests/test_torch_multihost.py`` starts two and holds their checksums
against each other and against the JAX package's single-process iteration
of the same schedule.

    python -m rag_snvbert_tpu_torch.tools.multihost_worker \\
        RANK NPROCS RENDEZVOUS_FILE OUT.json
"""

from __future__ import annotations

import json
import sys

import torch
import torch.distributed as dist

from ..data.pipeline import WindowDataset
from ..io.synthetic import make_bundle
from ..parallel.comm import all_reduce
from ..parallel.mesh import (DATA_AXIS, axis_group, axis_rank,
                             init_distributed, make_mesh)
from ..parallel.multihost import global_batch


def checksums(mesh, local: dict, batch_size: int) -> dict:
    """``{leaf: [sum, weighted sum]}`` of the global batch (float64)."""
    per = batch_size // mesh.shape[0]
    lo = axis_rank(mesh, DATA_AXIS) * per
    sums = []
    for v in local.values():
        v = v.double()
        w = 1.0 + torch.arange(lo, lo + v.shape[0], dtype=torch.float64)
        wv = v * w.reshape((-1,) + (1,) * (v.dim() - 1))
        sums.append(torch.stack([v.sum(), wv.sum()]))
    total = all_reduce(torch.stack(sums), axis_group(mesh, DATA_AXIS))
    return {k: [float(x) for x in total[i]] for i, k in enumerate(local)}


def main(argv=None) -> None:
    rank, nprocs, rendezvous, out = (argv or sys.argv[1:])[:4]
    rank, nprocs = int(rank), int(nprocs)
    init_distributed("gloo", rank=rank, world_size=nprocs,
                     init_method=f"file://{rendezvous}")
    try:
        mesh = make_mesh(nprocs, 1, 1, device="cpu")
        # the same bundle and seed on every rank: the schedule is shared
        b = make_bundle(n_train_samples=12, n_ref_samples=12, n_sites=96,
                        n_windows=2, seed=23)
        ds = WindowDataset(b.train, b.panel, b.freq, b.window.window_info,
                           b.vocab, ref_vcf=b.ref, seq_len=80)
        records = []
        for meta, local in ds.epoch_batches(batch_size=8, epoch=0, level=2,
                                            host_id=rank, n_hosts=nprocs):
            gb = global_batch(mesh, local, device="cpu")
            records.append({"window": int(meta.window_idx),
                            "sums": dict(sorted(checksums(mesh, gb,
                                                          8).items()))})
        with open(out, "w") as f:
            json.dump(records, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
