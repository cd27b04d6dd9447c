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
  :func:`all_gather_autograd` concatenates along any dim and is
  differentiable: each rank's gradient is its own block of the output's
  gradient (for a whole that every rank reads alike, or of which each rank
  reads only its own block downstream).
- :func:`reduce_scatter`: sum, then this rank's block of
  ``scatter_dimension`` (``psum_scatter(tiled=True)``).
- :func:`ring_shift`: rank i's output is rank i-shift's input
  (``ppermute``), through ``batch_isend_irecv``, the upstream's
  ``dist_sendrecv`` ring. gloo's point-to-point path moves host memory, so
  under gloo a CUDA tensor goes through a host copy each way. Autograd
  differentiates it: the gradient goes back by the shift the other way
  (the ring attention of ``ring.py`` rotates K/V with it).
- :func:`neighbour_exchange`: a pipeline tick's two hops, rank i's
  activation to i+1 and its cotangent to i−1 (the ``ppermute`` s of JAX's
  ``pipeline.py``, without the wrap-around nobody reads), on the same
  staged point-to-point path as :func:`ring_shift`; :func:`broadcast`, one
  rank's tensor to every rank of the axis (JAX's masked ``psum``).
- :func:`all_to_all`: ``jax.lax.all_to_all(tiled=True)``: ``split_dim``
  cut into one block a rank, block j sent to rank j, the blocks received
  concatenated along ``concat_dim`` in rank order; its gradient is the
  inverse swap (ulysses' head/sequence swap in ``ulysses.py``).
- :func:`axis_index`, :func:`axis_size`.
- :func:`pmax`: the all-reduce max (``jax.lax.pmax``).
- Counting mode (``ops/flop_count.count_collectives`` and ``count_flops``):
  the axis sizes and this rank's coordinates come from the counter, each
  collective records its JAX primitive name and the bytes it sends, and
  returns an output of the right shape (its values unset) without a process
  group.
- Tensor parallelism's pair (Megatron's f and g): :func:`tp_enter`, the
  identity whose backward all-reduces, before a column-parallel product;
  :func:`tp_leave`, the all-reduce whose backward is the identity, after a
  row-parallel product. Expert parallelism uses the same pair over ``ep``:
  each rank's experts contribute their part of the gradient of the MoE
  layer's input and gates, and their part of its output. (:func:`psum_autograd` sums in its backward too:
  right for a statistic every rank's loss reads, wrong after a row-parallel
  product, where it would multiply every gradient upstream by the axis
  size.)
"""

from __future__ import annotations

import torch

from ..ops.flop_count import counter


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

    c = counter()
    if c is not None:
        return c.axis_size(axis)
    if mesh is None:
        return world()[1]
    return dist.get_world_size(_group(axis, mesh))


def axis_index(axis: str, mesh=None) -> int:
    """This rank's coordinate along ``axis``."""
    import torch.distributed as dist

    c = counter()
    if c is not None:
        return c.axis_index(axis)
    if mesh is None:
        return world()[0]
    _group(axis, mesh)  # validates the name
    return mesh.get_local_rank(axis)


def _all_reduce(x: torch.Tensor, axis: str, mesh, op: str) -> torch.Tensor:
    """A new tensor: ``x`` all-reduced with ``op`` over ``axis``."""
    import torch.distributed as dist

    out = x.clone()
    c = counter()
    if c is not None:
        if axis_size(axis, mesh) > 1:
            c.collective({"SUM": "psum", "MAX": "pmax"}[op], x)
    elif axis_size(axis, mesh) > 1:
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
    elif (c := counter()) is not None:
        c.collective("all_gather", x)
    else:
        dist.all_gather_into_tensor(stacked, x.unsqueeze(0).contiguous(), group=_group(axis, mesh))
    return stacked.flatten(0, 1) if tiled else stacked


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.block = (dim, axis_index(axis, mesh) * x.shape[dim], x.shape[dim])
        return all_gather(x.movedim(dim, 0).contiguous(), axis, mesh).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(*ctx.block), None, None, None


def all_gather_autograd(x: torch.Tensor, axis: str, mesh=None, *, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in rank order
    (:func:`all_gather`, tiled), differentiable: the gradient of this rank's
    ``x`` is its own block of the output's gradient, not summed over the
    axis. Right where the gradient of another rank's block is that rank's
    to take: every rank's loss reads the same whole (the global views of
    ``ring.py`` and ``ulysses.py``), or each rank keeps only its own block
    of what it computes from the whole (ulysses' heads under tp)."""
    return _AllGather.apply(x, axis, mesh, dim)


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
    if (c := counter()) is not None:
        c.collective("reduce_scatter", x)
        return out.movedim(0, scatter_dimension)
    dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM, group=_group(axis, mesh))
    return out.movedim(0, scatter_dimension)


def _p2p(sends, recvs, axis: str, mesh) -> list:
    """Point-to-point transfers over ``axis`` in one ``batch_isend_irecv``:
    ``sends`` ``(tensor, peer, tag)``, ``recvs`` ``(like, peer, tag)`` (a
    buffer shaped, typed and placed like ``like``), peers by coordinate on
    the axis. Returns the received tensors in ``recvs``' order. gloo's
    point-to-point moves host memory only (a CUDA tensor aborts it), so
    under gloo a CUDA tensor is staged through a host copy each way."""
    import torch.distributed as dist

    group = _group(axis, mesh)

    def global_rank(r: int) -> int:
        return r if group is None else dist.get_global_rank(group, r)

    staged = dist.get_backend(group) == "gloo"

    def host(t):
        return t.cpu() if staged and t.is_cuda else t

    bufs = [torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged and like.is_cuda else like.device)
            for like, _, _ in recvs]
    ops = [dist.P2POp(dist.isend, host(t).contiguous(), global_rank(peer), group, tag)
           for t, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, buf, global_rank(peer), group, tag)
            for buf, (_, peer, tag) in zip(bufs, recvs)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [buf.to(like.device) for buf, (like, _, _) in zip(bufs, recvs)]


def _ring_shift(x: torch.Tensor, axis: str, mesh, shift: int) -> torch.Tensor:
    n = axis_size(axis, mesh)
    if n == 1 or shift % n == 0:
        return x.clone()
    if (c := counter()) is not None:
        c.collective("ppermute", x)
        return torch.empty_like(x)
    i = axis_index(axis, mesh)
    (out,) = _p2p([(x, (i + shift) % n, 0)], [(x, (i - shift) % n, 0)], axis, mesh)
    return out


def neighbour_exchange(fwd, bwd, axis: str, mesh=None) -> tuple:
    """One tick of a pipeline's hops along ``axis`` (JAX's two ``ppermute``
    s of a schedule tick, in one batch of point-to-point transfers): rank i
    sends ``fwd`` to i+1 and ``bwd`` to i−1, and returns ``(from i−1, from
    i+1)``, None where it has no such neighbour. Not a ring: the last rank's
    ``fwd`` and the first's ``bwd`` go nowhere. Either argument may be None
    on every rank (that hop is skipped); a received tensor is shaped like the
    local one of its direction. Every rank of the axis must call it."""
    n, i = axis_size(axis, mesh), axis_index(axis, mesh)
    sends, recvs, slots = [], [], []
    for t, to, frm, tag in ((fwd, i + 1, i - 1, 0), (bwd, i - 1, i + 1, 1)):
        if t is None:
            slots.append(False)
            continue
        if 0 <= to < n:
            sends.append((t, to, tag))
        slots.append(0 <= frm < n)
        if slots[-1]:
            recvs.append((t, frm, tag))
    c = counter()
    if c is not None:
        # Every rank takes part in each hop, as in JAX's SPMD ppermute.
        if n > 1:
            for t in (fwd, bwd):
                if t is not None:
                    c.collective("ppermute", t)
        got = iter([torch.empty_like(like) for like, _, _ in recvs])
    else:
        got = iter(_p2p(sends, recvs, axis, mesh)) if n > 1 else iter(())
    return tuple(next(got) if has else None for has in slots)


def broadcast(x: torch.Tensor, axis: str, mesh=None, *, src: int = 0) -> torch.Tensor:
    """A new tensor: the value of ``x`` on the rank at coordinate ``src`` of
    ``axis``, on every rank of it (JAX's masked ``psum`` of one rank's value).
    Under gloo a CUDA tensor goes through a host copy, as
    :func:`ring_shift`'s."""
    import torch.distributed as dist

    if axis_size(axis, mesh) == 1:
        return x.clone()
    if (c := counter()) is not None:
        c.collective("psum", x)  # JAX's masked psum
        return x.clone()
    group = _group(axis, mesh)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    buf = (x.cpu() if staged else x.clone()).contiguous()
    root = src if group is None else dist.get_global_rank(group, src)
    dist.broadcast(buf, root, group=group)
    return buf.to(x.device) if staged else buf


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, shift):
        ctx.axis, ctx.mesh, ctx.shift = axis, mesh, shift
        return _ring_shift(x, axis, mesh, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring_shift(g, ctx.axis, ctx.mesh, -ctx.shift), None, None, None


def ring_shift(x: torch.Tensor, axis: str, mesh=None, *, shift: int = 1) -> torch.Tensor:
    """Cyclic shift along ``axis``: this rank sends to ``(i + shift) % n``
    and receives from ``(i - shift) % n``. The gradient of the input is the
    output's gradient shifted back (``-shift``)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Shift.apply(x, axis, mesh, shift)
    return _ring_shift(x, axis, mesh, shift)


def _all_to_all(x: torch.Tensor, axis: str, mesh, split_dim: int, concat_dim: int) -> torch.Tensor:
    import torch.distributed as dist

    n = axis_size(axis, mesh)
    if x.shape[split_dim] % n:
        raise ValueError(
            f"all_to_all: dim {split_dim} of size {x.shape[split_dim]} does not split over {n} ranks"
        )
    if n == 1:
        return x.clone()
    # Block j of split_dim first, for all_to_all_single's equal dim-0 split.
    blocks = x.movedim(split_dim, 0)
    blocks = blocks.reshape(n, blocks.shape[0] // n, *blocks.shape[1:]).contiguous()
    out = torch.empty_like(blocks)
    if (c := counter()) is not None:
        c.collective("all_to_all", x)
    else:
        dist.all_to_all_single(out, blocks, group=_group(axis, mesh))
    # out[j] is rank j's block: put split_dim back, then rank j's blocks
    # side by side along concat_dim.
    out = out.movedim(1, split_dim + 1).movedim(0, concat_dim)
    return out.flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, split_dim, concat_dim):
        ctx.args = (axis, mesh, split_dim, concat_dim)
        return _all_to_all(x, axis, mesh, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, mesh, split_dim, concat_dim = ctx.args
        return _all_to_all(g, axis, mesh, concat_dim, split_dim), None, None, None, None


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int, mesh=None) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``split_dim`` cut into ``n`` equal blocks, block j sent to rank j; the
    ``n`` blocks this rank receives concatenated along ``concat_dim`` in
    rank order. Autograd differentiates it by the inverse swap."""
    return _AllToAll.apply(x, axis, mesh, split_dim, concat_dim)
