"""Collectives over one axis of the mesh, and their differentiable forms.

Two collectives reach ``torch.distributed``: ``all_reduce`` (sum or max)
and ``all_gather`` (parts of unequal length padded to the longest first).
Both take CUDA tensors under gloo, which two ranks sharing one card run on,
as under NCCL. A collective on an axis of one rank is the identity.

The tensor-parallel layers use three autograd functions of Megatron-LM
(its fourth, the column-parallel input's all-reduce of the gradient, is
``models/decoder.py`` ``column_parallel``, which sums in float32):

- ``reduce_from(x, axis)``: all-reduce forward, identity backward (the
  output of a row-parallel layer);
- ``gather_from(x, axis, dim)``: each rank's part concatenated along
  ``dim`` forward, this rank's part of the gradient backward;
- ``scatter_to(x, axis, dim)``: this rank's part forward, the gradient
  gathered backward.

There is no fallback: a failed collective raises.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import Axis


def all_reduce(t: torch.Tensor, axis: Optional[Axis], op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over ``axis`` ("sum" or "max"); returns it."""
    if axis is None or axis.size == 1:
        return t
    dist.all_reduce(t, {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=axis.group)
    return t


def split_sizes(n: int, count: int) -> List[int]:
    """The sizes of ``torch.tensor_split``'s ``count`` parts of ``n``."""
    return [n // count + (1 if i < n % count else 0) for i in range(count)]


def part(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's part of ``x`` along ``dim`` (``tensor_split``: the first
    n % size parts one longer)."""
    return torch.tensor_split(x, axis.size, dim=dim)[axis.index]


def all_gather(x: torch.Tensor, axis: Optional[Axis], dim: int, full: Optional[int] = None) -> torch.Tensor:
    """Every rank's part concatenated along ``dim`` in rank order. ``full``
    is the gathered length when the parts differ in length (the
    ``tensor_split`` parts of it); by default the parts are equal."""
    if axis is None or axis.size == 1:
        return x
    dim = dim % x.dim()
    sizes = split_sizes(full, axis.size) if full is not None else [x.shape[dim]] * axis.size
    longest = max(sizes)
    if x.shape[dim] < longest:
        pad = list(x.shape)
        pad[dim] = longest - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim=dim)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, full):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x.contiguous(), axis, dim, full)

    @staticmethod
    def backward(ctx, g):
        return part(g, ctx.axis, ctx.dim).contiguous(), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.full = axis, dim, x.shape[dim]
        return part(x, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.axis, ctx.dim, ctx.full), None, None


def _active(axis: Optional[Axis]) -> bool:
    return axis is not None and axis.size > 1


def reduce_from(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    return _ReduceFrom.apply(x, axis) if _active(axis) else x


def gather_from(x: torch.Tensor, axis: Optional[Axis], dim: int, full: Optional[int] = None) -> torch.Tensor:
    return _GatherFrom.apply(x, axis, dim % x.dim(), full) if _active(axis) else x


def scatter_to(x: torch.Tensor, axis: Optional[Axis], dim: int) -> torch.Tensor:
    return _ScatterTo.apply(x, axis, dim % x.dim()) if _active(axis) else x
