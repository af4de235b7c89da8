"""Start a world of local ranks: each rank a process joined to one process
group, for the tests, the card check and the command line without
torchrun.

``spawn`` runs every rank in a child (``torch.multiprocessing``, spawn
start method) and returns each rank's return value; a rank that raises
ends the others and ``spawn`` raises.  ``run_with_local_ranks`` keeps rank
0 in the calling process (its stdin, stdout and exit code stay the
command's) and starts ranks 1..N-1 as children.  Both join the group
through a ``file://`` rendezvous in a fresh temporary directory: no port is
chosen, so any number of worlds may start side by side.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import init_distributed


def _rank_main(rank: int, world: int, fn, args: tuple | str, backend: str,
               rendezvous: str, result_dir: str | None, threads: int) -> None:
    if threads:
        torch.set_num_threads(threads)
    if isinstance(args, str):          # spawn's arguments, from their file
        args = torch.load(args, weights_only=False)
    init_distributed(backend, rank=rank, world_size=world,
                     init_method=f"file://{rendezvous}")
    try:
        out = fn(rank, *args)
        if result_dir is not None:
            torch.save(out, os.path.join(result_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), backend: str = "gloo",
          threads: int = 0) -> list:
    """``fn(rank, *args)`` on ``world`` child ranks of one process group;
    returns the ranks' return values (``torch.save``-able), in rank order.
    ``fn`` must be importable by name (a module-level function).
    ``threads``: intra-op threads a rank (0 keeps PyTorch's default).
    ``args`` reach the ranks through a file: the spawn start method writes
    what it pickles for a child into a pipe, and a write beyond the pipe's
    buffer would block for ever if the child died before reading it."""
    tmp = tempfile.mkdtemp(prefix="rag_snvbert_world_")
    try:
        args_file = os.path.join(tmp, "args.pt")
        torch.save(args, args_file)
        mp.start_processes(
            _rank_main, args=(world, fn, args_file, backend,
                              os.path.join(tmp, "rendezvous"), tmp, threads),
            nprocs=world, start_method="spawn", join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_with_local_ranks(fn, world: int, args: tuple = (),
                         backend: str = "nccl"):
    """``fn(rank, *args)`` with rank 0 in this process and ranks 1..N-1 in
    spawned children; returns rank 0's value.  A child that fails ends this
    process (exit code 1) rather than leaving rank 0 waiting in a
    collective."""
    tmp = tempfile.mkdtemp(prefix="rag_snvbert_world_")
    rendezvous = os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    children = [ctx.Process(target=_rank_main, daemon=False,
                            args=(r, world, fn, args, backend, rendezvous,
                                  None, 0))
                for r in range(1, world)]
    for p in children:
        p.start()
    done = threading.Event()

    def watch():
        while not done.wait(0.5):
            for p in children:
                if p.exitcode not in (None, 0):
                    print(f"rank {children.index(p) + 1} failed (exit code "
                          f"{p.exitcode}); stopping", flush=True)
                    os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    try:
        init_distributed(backend, rank=0, world_size=world,
                         init_method=f"file://{rendezvous}")
        try:
            out = fn(0, *args)
        finally:
            dist.destroy_process_group()
        for p in children:
            p.join()
    except BaseException:
        for p in children:
            if p.is_alive():
                p.terminate()
        raise
    finally:
        done.set()
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [r for r, p in enumerate(children, 1) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} failed")
    return out
