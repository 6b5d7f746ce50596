"""Collectives over one mesh axis that autograd differentiates.

The JAX package writes its model-parallel steps as ``shard_map`` programs
with ``check_vma=False`` and differentiates through them; the transpose of
each collective is then (``jax.lax`` names):

- ``psum``: an all-reduce SUM forward, an all-reduce SUM backward;
- ``all_gather(tiled=True)`` on a dim: a reduce-scatter SUM backward;
- ``psum_scatter(tiled=True)`` on a dim: an all-gather backward;
- ``ppermute`` a ring shift by one: the reverse shift backward.

Each is a ``torch.autograd.Function`` here with that backward, so a step's
backward issues the transposed collectives in the reverse order of its
forward, the same on every rank (the steps keep one program on every rank
for that reason).  ``reduce_scatter_tensor`` and ``all_gather_into_tensor``
join blocks on dim 0, so a collective on another dim moves that dim to the
front and back.  ``ppermute`` is an all-gather over the axis of which the
rank keeps its predecessor's block: it runs on the collectives that
``gloo`` (CPU and CUDA tensors) and NCCL both run, at the cost of
``(n - 1)`` blocks a rank where a point-to-point shift moves one (the
pipelines here have 2-4 stages).  At axis size 1 each returns its input.

``COUNTS`` tallies the calls and the bytes each rank hands to collectives
(of this module, and the gradient reductions of ``model_parallel``): the
payload, of which a ring all-reduce puts about ``2 (n - 1) / n`` on the
wire; :func:`reset_counts` zeroes it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from otto_tpu_torch.parallel.mesh import axis_index, axis_size

COUNTS = {"calls": 0, "bytes": 0}


def reset_counts() -> None:
    COUNTS["calls"] = COUNTS["bytes"] = 0


def count(x: torch.Tensor) -> None:
    """Tally one collective call on ``x``."""
    COUNTS["calls"] += 1
    COUNTS["bytes"] += x.numel() * x.element_size()


def _all_reduce(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    out = x.contiguous().clone()
    count(out)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out


def _gather(mesh, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` joined on ``dim`` in axis order."""
    n = axis_size(mesh, axis)
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((n * front.shape[0], *front.shape[1:]))
    count(front)
    dist.all_gather_into_tensor(out, front, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def _scatter(mesh, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's block on ``dim`` of ``x`` summed over the axis."""
    n = axis_size(mesh, axis)
    front = x.movedim(dim, 0).contiguous()
    if front.shape[0] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does not split over "
                         f"the {n} ranks of {axis!r}")
    out = front.new_empty((front.shape[0] // n, *front.shape[1:]))
    count(front)
    dist.reduce_scatter_tensor(out, front, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def _shift(mesh, x: torch.Tensor, axis: str, shift: int) -> torch.Tensor:
    """The ``x`` of the rank ``shift`` places before this one on the ring."""
    n = axis_size(mesh, axis)
    blocks = _gather(mesh, x.unsqueeze(0), axis, 0)
    return blocks[(axis_index(mesh, axis) - shift) % n]


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, g, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(ctx.mesh, g, ctx.axis, ctx.dim), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _scatter(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(ctx.mesh, g, ctx.axis, ctx.dim), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _shift(mesh, x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(ctx.mesh, g, ctx.axis, -ctx.shift), None, None, None


def psum(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` summed over ``axis`` (``jax.lax.psum``)."""
    return x if axis_size(mesh, axis) == 1 else _Psum.apply(x, mesh, axis)


def all_gather(mesh, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` joined on ``dim``
    (``jax.lax.all_gather(axis=dim, tiled=True)``)."""
    return x if axis_size(mesh, axis) == 1 else _AllGather.apply(x, mesh, axis, dim)


def psum_scatter(mesh, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's block on ``dim`` of ``x`` summed over ``axis``
    (``jax.lax.psum_scatter(scatter_dimension=dim, tiled=True)``)."""
    return x if axis_size(mesh, axis) == 1 else _PsumScatter.apply(x, mesh, axis, dim)


def ppermute(mesh, x: torch.Tensor, axis: str, shift: int = 1) -> torch.Tensor:
    """The ring shift ``i -> (i + shift) % n`` along ``axis``: each rank
    gets its ``shift``-th predecessor's ``x`` (``jax.lax.ppermute`` with
    those pairs)."""
    return x if axis_size(mesh, axis) == 1 else _Ppermute.apply(x, mesh, axis, shift)
