"""Collectives of the scale-out path, on any backend the process group runs.

Gloo carries CUDA tensors for ``broadcast`` and ``all_reduce`` only
(PyTorch's backend table): for ``all_gather`` and point-to-point a gloo
group stages a CUDA tensor through host memory.  The choice is made from
``dist.get_backend(group)``; an NCCL group never stages.  Ranks that share
one card run gloo (NCCL refuses two ranks on one device), so this is what
lets the same code run there, on the CPU and across cards.

The autograd functions are Megatron's: ``copy_to_group`` (``f``:
identity forward, gradient summed over the group backward) before a
column-parallel product, ``reduce_from_group`` (``g``: sum forward,
identity backward) after a row-parallel one, and ``all_reduce_sum`` (sum
both ways) for a statistic over a sharded dimension whose users are
themselves sharded (the FFN's LayerNorm); and ``gather_from_group``
(every rank's column slice concatenated forward, the gradient summed over
the group and sliced backward, as a reduce-scatter) where a rank needs
columns that other ranks computed (attention on a head that two ranks
share).  ``all_reduce_max`` (no gradient) is the max over the group of
the int8 products' scales.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``group`` must move ``t`` through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (every backend carries it)."""
    dist.all_reduce(t, group=group)
    return t


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group``, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``[group size, *t.shape]``: every rank's ``t``, in group-rank
    order."""
    src = t.cpu() if _staged(group, t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.to(t.device) if _staged(group, t) else out


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Send ``t`` to the next rank of ``group`` and return the previous
    rank's (group-rank order, wrapping): one neighbour exchange of a ring."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    src = t.cpu() if _staged(group, t) else t.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, nxt, group),
           dist.P2POp(dist.irecv, out, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device) if _staged(group, t) else out


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank of the world."""
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        ctx.rank = dist.get_rank(group)
        return torch.cat(list(all_gather(x, group).unbind(0)), -1)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.group)
        return g.narrow(-1, ctx.rank * ctx.width, ctx.width), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def gather_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last dim in group-rank
    order; the backward pass sums the gradient over the group and returns
    this rank's slice of it."""
    return _GatherFromGroup.apply(x, group)
