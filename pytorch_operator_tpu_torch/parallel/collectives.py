"""Collectives over one mesh axis — the port of
``pytorch_operator_tpu/parallel/collectives.py``.

JAX's wrappers run inside ``shard_map`` over a named axis; here every rank
is a process and an axis is the process group of one dimension of a
``DeviceMesh`` (``mesh.get_group(axis)``). Each function takes this rank's
tensor and returns a new one (the argument is left as it was). ``mesh=None``
means the whole world: the default process group, or a world of one process
when none was joined (then each collective is the identity, as JAX's are
over an axis of size 1).

- :func:`psum`, :func:`pmean`: all-reduce (the sum; the sum divided by the
  axis size). :func:`psum_autograd` is the differentiable sum (its backward
  sums the ranks' gradients, as JAX differentiates ``psum``).
- :func:`all_gather`: ``tiled`` concatenates the ranks' tensors along dim 0,
  else stacks them on a new leading dim (``jax.lax.all_gather``).
- :func:`reduce_scatter`: sum, then this rank's block of
  ``scatter_dimension`` (``psum_scatter(tiled=True)``).
- :func:`ring_shift`: rank i's output is rank i-shift's input
  (``ppermute``), through ``batch_isend_irecv``, the upstream's
  ``dist_sendrecv`` ring. gloo's point-to-point path moves host memory, so
  under gloo a CUDA tensor goes through a host copy each way.
- :func:`axis_index`, :func:`axis_size`.
- :func:`pmax`: the all-reduce max (``jax.lax.pmax``).
- Tensor parallelism's pair (Megatron's f and g): :func:`tp_enter`, the
  identity whose backward all-reduces, before a column-parallel product;
  :func:`tp_leave`, the all-reduce whose backward is the identity, after a
  row-parallel product. (:func:`psum_autograd` sums in its backward too:
  right for a statistic every rank's loss reads, wrong after a row-parallel
  product, where it would multiply every gradient upstream by the axis
  size.)
"""

from __future__ import annotations

import torch


def _group(axis: str, mesh):
    """The process group of ``axis`` of ``mesh``; None (the default group)
    for the whole world."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")
    return mesh.get_group(axis)


def world() -> tuple:
    """``(rank, size)`` of the joined world; ``(0, 1)`` when no process
    group was joined. The one place the port asks ``torch.distributed``
    whether it runs in a world: the layers above take the answer from
    their caller."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def axis_size(axis: str, mesh=None) -> int:
    """Ranks along ``axis`` (the world's size for ``mesh=None``)."""
    import torch.distributed as dist

    if mesh is None:
        return world()[1]
    return dist.get_world_size(_group(axis, mesh))


def axis_index(axis: str, mesh=None) -> int:
    """This rank's coordinate along ``axis``."""
    import torch.distributed as dist

    if mesh is None:
        return world()[0]
    _group(axis, mesh)  # validates the name
    return mesh.get_local_rank(axis)


def _all_reduce(x: torch.Tensor, axis: str, mesh, op: str) -> torch.Tensor:
    """A new tensor: ``x`` all-reduced with ``op`` over ``axis``."""
    import torch.distributed as dist

    out = x.clone()
    if axis_size(axis, mesh) > 1:
        dist.all_reduce(out, op=getattr(dist.ReduceOp, op), group=_group(axis, mesh))
    return out


def psum(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    return _all_reduce(x, axis, mesh, "SUM")


def pmax(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    return _all_reduce(x, axis, mesh, "MAX")


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return psum(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axis, ctx.mesh), None, None


def psum_autograd(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """:func:`psum` that autograd differentiates: the gradient of each
    rank's input is the sum of the ranks' output gradients (every rank's loss
    reads the same sum)."""
    return _Psum.apply(x, axis, mesh)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axis, ctx.mesh), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return psum(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def tp_enter(x: torch.Tensor, axis: str = "tp", mesh=None) -> torch.Tensor:
    """``x`` as it is; its gradient is the sum over ``axis`` of the ranks'
    (each rank's column-parallel product contributes its part)."""
    return _Enter.apply(x, axis, mesh)


def tp_leave(x: torch.Tensor, axis: str = "tp", mesh=None) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' partial results of a row-parallel
    product; its gradient passes to each rank's part unchanged."""
    return _Leave.apply(x, axis, mesh)


def pmean(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    return psum(x, axis, mesh) / axis_size(axis, mesh)


def all_gather(x: torch.Tensor, axis: str, mesh=None, *, tiled: bool = True) -> torch.Tensor:
    import torch.distributed as dist

    if tiled and x.dim() == 0:
        raise ValueError("all_gather(tiled=True) needs a tensor of at least one dim")
    n = axis_size(axis, mesh)
    stacked = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
    if n == 1:
        stacked[0] = x
    else:
        dist.all_gather_into_tensor(stacked, x.unsqueeze(0).contiguous(), group=_group(axis, mesh))
    return stacked.flatten(0, 1) if tiled else stacked


def reduce_scatter(x: torch.Tensor, axis: str, mesh=None, *, scatter_dimension: int = 0) -> torch.Tensor:
    import torch.distributed as dist

    n = axis_size(axis, mesh)
    if x.shape[scatter_dimension] % n:
        raise ValueError(
            f"reduce_scatter: dim {scatter_dimension} of size {x.shape[scatter_dimension]} "
            f"does not split over {n} ranks"
        )
    moved = x.movedim(scatter_dimension, 0).contiguous()
    if n == 1:
        return moved.movedim(0, scatter_dimension).clone()
    out = torch.empty((moved.shape[0] // n, *moved.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM, group=_group(axis, mesh))
    return out.movedim(0, scatter_dimension)


def ring_shift(x: torch.Tensor, axis: str, mesh=None, *, shift: int = 1) -> torch.Tensor:
    """Cyclic shift along ``axis``: this rank sends to ``(i + shift) % n``
    and receives from ``(i - shift) % n``."""
    import torch.distributed as dist

    n = axis_size(axis, mesh)
    if n == 1 or shift % n == 0:
        return x.clone()
    group = _group(axis, mesh)
    i = axis_index(axis, mesh)

    def global_rank(r: int) -> int:
        return r if group is None else dist.get_global_rank(group, r)

    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    send = (x.cpu() if staged else x).contiguous()
    recv = torch.empty_like(send)
    ops = [
        dist.P2POp(dist.isend, send, global_rank((i + shift) % n), group),
        dist.P2POp(dist.irecv, recv, global_rank((i - shift) % n), group),
    ]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device) if staged else recv
