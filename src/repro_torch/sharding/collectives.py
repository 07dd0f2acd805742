"""Autograd-aware collectives of the mesh program, and their launch count.

Every function takes a ``torch.distributed`` process group, or None for a
group of one rank; a group of one rank launches nothing and returns its
input. :data:`COUNTS` counts the collectives launched, by kind, forward
and backward alike (``reset_counts`` clears it).

Gradient convention (the mesh program's): the objective is the sum over
the ranks of each rank's loss, and every collective's backward is its
transpose: an all-reduce's is the all-reduce of the cotangents, an
all-gather's the reduce-scatter and a reduce-scatter's the all-gather. A
rank's gradient of a value it holds is
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
    """This rank's block along ``dim`` of the group's sum of ``g`` (the dim
    divides over the group)."""
    n, r = group_size(group), dist.get_rank(group)
    chunks = [c.contiguous() for c in g.chunk(n, dim)]
    out = torch.empty_like(chunks[r])
    dist.reduce_scatter(out, chunks, group=group)
    launched("reduce_scatter")
    return out


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


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def reduce_scatter(t, dim: int, group):
    """This rank's block along ``dim`` of the group's sum of ``t`` (the sum
    of partial results, each rank keeping its block); its gradient is the
    all-gather of the cotangents."""
    if group_size(group) == 1:
        return t
    return _ReduceScatter.apply(t, dim, group)


@torch.no_grad()
def gather_nograd(t, dim: int, group):
    """:func:`all_gather` outside autograd (checkpoint saves)."""
    if group_size(group) == 1:
        return t
    return _gather(t, dim, group)


@torch.no_grad()
def all_to_all_nograd(t, group):
    """t [n, ...] (n the group's size): block i goes to group rank i, and
    block i of the result came from group rank i; outside autograd."""
    if group_size(group) == 1:
        return t
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    launched("all_to_all")
    return out


def _overlaps(ranges, lo: int, hi: int) -> list:
    """The pieces of the sorted [lo_i, hi_i) ``ranges`` inside [lo, hi)."""
    out = []
    for a, b in ranges:
        a, b = max(a, lo), min(b, hi)
        if a < b:
            out.append((a, b))
    return out


@torch.no_grad()
def fetch(t, dim: int, group, needs) -> torch.Tensor:
    """Regroup a dim split in equal blocks over ``group`` (this rank holds
    block ``rank`` of ``t.shape[dim]`` entries) into the entries each rank
    needs: ``needs[r]`` is rank r's sorted, disjoint [lo, hi) ranges of
    the whole dim (they may overlap other ranks' or be empty). Returns
    this rank's entries in order, from one all-to-all that moves only
    them; no collective where every rank needs exactly its own block."""
    n, r = group_size(group), (0 if group is None else dist.get_rank(group))
    blk = t.shape[dim]
    if all(tuple(needs[s]) == ((s * blk, (s + 1) * blk),)
           for s in range(n)):
        return t
    src = t.movedim(dim, 0)
    send, send_sizes = [], []
    for s in range(n):
        pieces = _overlaps(needs[s], r * blk, (r + 1) * blk)
        send += [src[a - r * blk:b - r * blk] for a, b in pieces]
        send_sizes.append(sum(b - a for a, b in pieces))
    recv_sizes = [sum(b - a for a, b in
                      _overlaps(needs[r], s * blk, (s + 1) * blk))
                  for s in range(n)]
    rest = src.shape[1:]
    inp = torch.cat(send, 0) if send else src.new_empty((0, *rest))
    out = src.new_empty((sum(recv_sizes), *rest))
    if n > 1:
        dist.all_to_all_single(out, inp.contiguous(),
                               output_split_sizes=recv_sizes,
                               input_split_sizes=send_sizes, group=group)
        launched("all_to_all")
    else:
        out = inp
    return out.movedim(0, dim)


@torch.no_grad()
def broadcast_host(value: float, group, device) -> float:
    """Global rank 0's host number on every rank of ``group`` (a group
    that holds rank 0), through a tensor on ``device``."""
    if group_size(group) == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0, group=group)
    launched("broadcast")
    return float(t.item())


def barrier(group) -> None:
    if group_size(group) > 1:
        dist.barrier(group=group)
