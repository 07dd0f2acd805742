"""Autograd-aware collectives of the mesh program, and their launch count.

Every function takes a ``torch.distributed`` process group, or None for a
group of one rank; a group of one rank launches nothing and returns its
input. :data:`COUNTS` counts the collectives launched, by kind, forward
and backward alike (``reset_counts`` clears it).

Gradient convention (the mesh program's): the objective is the sum over
the ranks of each rank's loss, and every collective's backward is its
transpose: an all-reduce's is the all-reduce of the cotangents, an
all-gather's the reduce-scatter. A rank's gradient of a value it holds is
then that rank's share of the global gradient, and the global gradient of
a leaf replicated over some ranks is the sum of their shares.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

COUNTS: dict = {}


def reset_counts() -> None:
    COUNTS.clear()


def launched(kind: str) -> None:
    COUNTS[kind] = COUNTS.get(kind, 0) + 1


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _sum(t, group):
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    launched("all_reduce")
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_reduce(t, group):
    """Sum over the group; its gradient sums the cotangents."""
    if group_size(group) == 1:
        return t
    return _AllReduce.apply(t, group)


@torch.no_grad()
def all_reduce_max(t, group):
    """Elementwise max over the group, outside autograd."""
    if group_size(group) == 1:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    launched("all_reduce")
    return out


def _gather(t, dim: int, group):
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    launched("all_gather")
    return torch.cat(parts, dim=dim)


def _reduce_scatter(g, dim: int, group):
    """This rank's block along ``dim`` of the group's sum of ``g``."""
    n, r = group_size(group), dist.get_rank(group)
    if dist.get_backend(group) == "nccl":
        chunks = [c.contiguous() for c in g.chunk(n, dim)]
        out = torch.empty_like(chunks[r])
        dist.reduce_scatter(out, chunks, group=group)
        launched("reduce_scatter")
        return out
    # gloo has no reduce-scatter: the sum, then this rank's block
    return _sum(g, group).chunk(n, dim)[r].contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


def all_gather(t, dim: int, group):
    """The group's blocks concatenated along ``dim`` in group-rank order
    (the FSDP gather of a weight at use); its gradient is the
    reduce-scatter of the cotangents."""
    if group_size(group) == 1:
        return t
    return _AllGather.apply(t, dim, group)


@torch.no_grad()
def gather_nograd(t, dim: int, group):
    """:func:`all_gather` outside autograd (checkpoint saves)."""
    if group_size(group) == 1:
        return t
    return _gather(t, dim, group)


def barrier(group) -> None:
    if group_size(group) > 1:
        dist.barrier(group=group)
