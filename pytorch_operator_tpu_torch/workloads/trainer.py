"""The training loop's shared parts — the port of what the LM path and the
image benches use from ``pytorch_operator_tpu/workloads/trainer.py``.

- :func:`make_optimizer`: AdamW with optax's defaults (b1 0.9, b2 0.999,
  eps 1e-8, decoupled weight decay on every parameter), or optax's
  ``adafactor`` (:class:`Adafactor`, computed on the JAX param leaves); an
  optional linear warmup + cosine decay read at the step count before the
  update, and an optional global-norm clip written as optax's
  ``clip_by_global_norm``.
- :func:`make_lm_loss_fn` / :func:`make_lm_train_step` /
  :func:`make_lm_eval_step`: next-token cross-entropy (dense f32 logits, or
  the chunked-vocab loss) plus ``moe_aux_weight`` times a MoE model's
  load-balance loss, one step of it with optional gradient accumulation
  summed in f32, and the held-out cross-entropy without gradients (and
  without the aux term).
- :class:`ProgressHeartbeat`, :func:`heartbeat_reporter` and
  :func:`throughput_loop`: the timed loop, its checkpoint saves, its live
  heartbeat, the flight recorder's ``step`` and ``save`` spans, and
  :func:`maybe_profile` (``torch.profiler``) around the timed window.
- :func:`data_plane_env`, :func:`add_feed_tuning_args` and
  :func:`resolve_feed_tuning`: the ``spec.data_plane`` env defaults of the
  async-checkpoint and device-feed flags.
- The image benches' parts (``resnet_bench``, ``vit_bench``):
  :func:`probe_image_file` and :func:`open_image_feed` (a packed image file,
  validated, stacked per chunk, optionally prefetched),
  :func:`timed_windows` and :func:`window_progress` (the fenced and
  sustained windows and their live meter), :func:`chunk_plan` and
  :func:`image_bench_loop` (JAX's chunking, around both), and
  :func:`average_gradients_` (dp over whole parameters).

PyTorch runs eagerly, so there is no jit: the model and the optimizer hold
the state, and ``train_step(tokens)`` updates both in place and returns the
loss as a device tensor. In a world of more than one process the model's
parameters are DTensors over the data axes (``parallel/sharding.shard_model``)
and, under tp, each rank's blocks of the split tensors: the clip takes the
global norm over the shards and blocks (a tensor replicated over tp counts
once), the accumulation buffers are laid out like the gradients, the
adafactor statistics are reduced over the axes that split each JAX leaf
(:class:`Adafactor`), a tensor-parallel model's loss is the vocab-parallel
one, and :func:`world_mean` turns a rank's loss into the global batch's.
Not ported here: pipeline parallelism (ROADMAP.md item 3c-3).
"""

from __future__ import annotations

import contextlib
import math
import os
import socket
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str], log=print):
    """Run the block under ``torch.profiler`` (host ops, and the card's
    kernels when there is one) when ``profile_dir`` is set, then write the
    trace there as ``<host>.<pid>.pt.trace.json`` (Chrome trace format; read
    it with ``python -m pytorch_operator_tpu_torch.profiling``). Yields the
    profiler, or None. Take timings inside the block: writing the trace
    comes after it."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        out = Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{socket.gethostname()}.{os.getpid()}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        log(f"profile trace written to {path}")


def _env_int(name: str) -> int:
    try:
        return max(int(os.environ.get(name, "0")), 0)
    except ValueError:
        return 0


def data_plane_env() -> dict:
    """The supervisor-injected ``spec.data_plane`` knobs (``runtime/env.py``
    of the JAX package) as a dict: the one place the ``--async-checkpoint``,
    ``--prefetch``, ``--prefetch-depth-max``, ``--feed-autotune`` and
    ``--prefetch-workers`` flags read their defaults. Explicit flags win."""
    return {
        "async_checkpoint": os.environ.get("TPUJOB_ASYNC_CHECKPOINT", "").lower() in ("1", "true"),
        "prefetch": _env_int("TPUJOB_PREFETCH"),
        "prefetch_depth_max": _env_int("TPUJOB_PREFETCH_DEPTH_MAX"),
        "autotune": os.environ.get("TPUJOB_FEED_AUTOTUNE", "").lower() in ("1", "true"),
        "prefetch_workers": _env_int("TPUJOB_PREFETCH_WORKERS"),
    }


def data_plane_env_defaults() -> tuple:
    """``(async_checkpoint, prefetch)`` of :func:`data_plane_env`."""
    dp = data_plane_env()
    return dp["async_checkpoint"], dp["prefetch"]


def add_feed_tuning_args(p) -> None:
    """The feed's three tuning flags, defined once for every workload with
    ``--prefetch``. ``None`` defaults mean "the spec.data_plane env": resolve
    with :func:`resolve_feed_tuning`."""
    import argparse as _ap

    p.add_argument(
        "--prefetch-depth-max", type=int, default=None, metavar="N",
        help="upper bound the feed's device lookahead may grow to (device-memory "
        "budget; default: spec.data_plane / TPUJOB_PREFETCH_DEPTH_MAX, else the "
        "static --prefetch depth)",
    )
    p.add_argument(
        "--feed-autotune", action=_ap.BooleanOptionalAction, default=None,
        help="let the feed resize its depth inside [1, --prefetch-depth-max] from "
        "the measured step-loop stall (grow fast, shrink slow — "
        "data/feed_autotune.py). Default: spec.data_plane / TPUJOB_FEED_AUTOTUNE",
    )
    p.add_argument(
        "--prefetch-workers", type=int, default=None, metavar="N",
        help="producer threads of the feed (batch order stays FIFO; copies and "
        "transfers overlap). Default: spec.data_plane / TPUJOB_PREFETCH_WORKERS, else 1",
    )


def resolve_feed_tuning(args) -> dict:
    """The :func:`add_feed_tuning_args` flags merged with the spec defaults
    (explicit flags win), as ``llama_train.run``'s keyword values."""
    env = data_plane_env()
    depth_max = args.prefetch_depth_max if args.prefetch_depth_max is not None else env["prefetch_depth_max"]
    autotune = args.feed_autotune if args.feed_autotune is not None else env["autotune"]
    workers = args.prefetch_workers if args.prefetch_workers is not None else env["prefetch_workers"]
    return {
        "prefetch_depth_max": max(depth_max, 0),
        "autotune": bool(autotune),
        "prefetch_workers": max(workers, 0),
    }


def lr_at(count: int, lr: float, *, schedule: str, warmup_steps: int, decay_steps) -> float:
    """The learning rate of the update made at optimizer step ``count``
    (0-based): constant, or optax's ``warmup_cosine_decay_schedule(0, lr,
    max(warmup, 1), max(decay or warmup+1, warmup+1))`` — ``decay_steps``
    includes the warmup."""
    if schedule == "constant":
        return lr
    if schedule != "cosine":
        raise ValueError(f"schedule={schedule!r} not in ('constant', 'cosine')")
    warm = max(warmup_steps, 1)
    decay = max(decay_steps or warmup_steps + 1, warmup_steps + 1)
    if decay <= warm:
        raise ValueError(
            f"cosine schedule needs decay steps > warmup steps, got {decay} <= {warm}"
        )
    if count < warm:
        return lr * count / warm
    t = min(count - warm, decay - warm)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / (decay - warm)))


def _sharded_sq_norm(grads, tp_split=None, tp=None) -> torch.Tensor:
    """The squared global norm of gradients laid out over a mesh: each
    gradient's local squares summed by the axes that split it (the mesh
    dimensions a DTensor is sharded on; tp where ``tp_split`` says tp splits
    it), each such sum all-reduced over those axes (a replicated axis holds
    whole copies: not summed), then added up."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    sums: dict = {}
    for i, g in enumerate(grads):
        groups = []
        if isinstance(g, DTensor):
            groups = [g.device_mesh.get_group(d) for d, pl in enumerate(g.placements) if pl.is_shard()]
            g = g.to_local()
        if tp_split is not None and tp_split[i] and tp is not None and tp.size > 1:
            groups.append(tp.mesh.get_group("tp"))
        key = tuple(groups)
        sums[key] = sums.get(key, 0) + torch.linalg.vector_norm(g.float()).square()
    total = 0
    for groups, sq in sums.items():  # the same order on every rank
        for group in groups:
            dist.all_reduce(sq, group=group)
        total = total + sq
    return total


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float, tp_split=None, tp=None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: ``g · max_norm / ‖g‖`` when
    ``‖g‖ >= max_norm``, unchanged otherwise, with no epsilon (unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the global norm (a device
    scalar; no host sync). Sharded gradients (DTensors, and tp's blocks:
    ``tp_split[i]`` says whether ``tp`` splits ``grads[i]``) give the norm
    over the whole gradient, not over this rank's parts."""
    from ..parallel.sharding import local_tensor

    local = [local_tensor(g) for g in grads]
    if any(t is not g for t, g in zip(local, grads)) or (tp is not None and tp.size > 1):
        norm = _sharded_sq_norm(grads, tp_split, tp).sqrt()
    else:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
        )
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(local, factor)
    return norm


def world_mean(x: torch.Tensor, world: int, mesh=None) -> torch.Tensor:
    """The mean of a per-rank value over the joined world of ``world``
    processes (each rank's loss is the mean over its equal share of the
    global batch, so this is the global batch's); ``x`` itself in a world
    of one process. With ``mesh``, the mean over its data axes (the ranks
    of one tp group hold the same rows and the same loss)."""
    import torch.distributed as dist

    if world == 1:
        return x
    out = x.detach().clone()
    if mesh is None:
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out / world
    from ..parallel.collectives import psum
    from ..parallel.mesh import DATA_AXES, axis_sizes, train_coords

    for axis in DATA_AXES:
        if axis_sizes(mesh).get(axis, 1) > 1:
            out = psum(out, axis, mesh)
    return out / train_coords(mesh).data_extent


class Optimizer:
    """AdamW over ``params`` with the schedule and clip of
    :func:`make_optimizer`. ``step()`` reads each parameter's ``.grad``,
    updates the parameters in place and clears the gradients."""

    def __init__(self, params, lr: float, *, schedule: str, warmup_steps: int,
                 decay_steps, grad_clip: Optional[float], weight_decay: float,
                 tp_dims=None, tp=None):
        params = list(params)
        # tp_dims: the dim tp splits of each parameter (None: replicated),
        # for the clip's norm and the checkpoint's blocks.
        dims = tp_dims if tp_dims is not None else [None] * len(params)
        kept = [(p, d) for p, d in zip(params, dims) if p.requires_grad]
        self.params = [p for p, _ in kept]
        self.tp_dims = [d for _, d in kept]
        self.tp = tp
        self.lr = lr
        self.schedule = dict(schedule=schedule, warmup_steps=warmup_steps,
                             decay_steps=decay_steps)
        lr_at(0, lr, **self.schedule)  # validate the schedule name now
        self.grad_clip = grad_clip
        # One parameter group, decay on every parameter (optax's adamw has
        # no mask): p <- p·(1 − lr·wd) − lr·m̂/(√v̂ + eps), optax's update.
        self.adamw = torch.optim.AdamW(
            self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
        )
        self.count = 0

    def step(self) -> None:
        if self.grad_clip is not None:
            clip_by_global_norm_([p.grad for p in self.params], self.grad_clip,
                                 [d is not None for d in self.tp_dims], self.tp)
        for group in self.adamw.param_groups:
            group["lr"] = lr_at(self.count, self.lr, **self.schedule)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        """The optimizer state a checkpoint carries: the update count (the
        schedule's step, optax's ``count``) and AdamW's moments and
        bias-correction steps; under tp each moment as the
        ``sharding.Block`` of its parameter's layout."""
        sd = self.adamw.state_dict()
        if self.tp is not None and self.tp.size > 1:
            from ..parallel.sharding import Block

            sd["state"] = {
                i: {k: Block.of(t, self.tp_dims[i], self.tp) if k != "step" else t
                    for k, t in st.items()}
                for i, st in sd["state"].items()
            }
        return {"count": self.count, "adamw": sd}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])

    def state_nbytes(self) -> int:
        """Bytes of the optimizer's state tensors on this rank (AdamW: two
        moments a parameter, 2N f32 over the ranks that shard them, and a
        step scalar a parameter)."""
        from ..parallel.sharding import local_nbytes

        return local_nbytes(
            t for st in self.adamw.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)
        )

    @torch.no_grad()
    def init_state(self) -> None:
        """Create AdamW's state now, as its first step would (a zero step
        count, zero moments shaped and placed like each parameter), so that
        :meth:`state_dict` has the layout a restore fills: under FSDP the
        moments are DTensors sharded like their parameters. The first update
        is unchanged."""
        for p in self.params:
            if not self.adamw.state[p]:
                self.adamw.state[p] = {
                    "step": torch.tensor(0.0, dtype=torch.float32),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                }


def _factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax's ``factorized._factored_dims``: the two largest axes of a leaf
    of ``shape``, ``(d1, d0)`` with d0 the largest, or None when the second
    largest is below ``min_dim_size_to_factor`` (or the leaf is 1-D).
    ``np.argsort`` breaks ties as optax's does."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to f32 and then to ``dtype``, as a Python float: the
    value optax multiplies by when it casts a scalar to the leaf's dtype."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


class _LeafLayout:
    """Where a rank's part of one JAX leaf of shape ``whole`` sits
    (``offsets``, ``sizes`` in the leaf), and, for each dim of the leaf, the
    mesh axes that split it."""

    def __init__(self, offsets, sizes, split, whole):
        self.offsets, self.sizes, self.split, self.whole = tuple(offsets), tuple(sizes), split, tuple(whole)

    @classmethod
    def of_whole(cls, shape) -> "_LeafLayout":
        return cls([0] * len(shape), shape, [()] * len(shape), shape)


def _leaf_layout(leaf, param, name: str, tp, mesh) -> _LeafLayout:
    """The :class:`_LeafLayout` of ``leaf`` on this rank, ``param`` the
    port tensor of its first name (each layer's alike): tp's block of the
    port tensor, then FSDP2's rows of that block, mapped into the leaf; an
    axis splits a leaf dim when another coordinate on it holds another range
    of that dim. An axis that would split two dims raises
    NotImplementedError."""
    from ..parallel.mesh import axis_sizes, train_coords
    from ..parallel.sharding import Block, tp_dim

    sizes = axis_sizes(mesh)
    fsdp = sizes.get("fsdp", 1)
    dim = tp_dim(name) if tp is not None else None
    whole = list(param.shape)  # FSDP2's global shape: the tp block's
    if dim is not None:
        whole[dim] *= tp.size

    def port_box(t: int, f: int):
        offs, size = [0] * len(whole), list(whole)
        if dim is not None:
            size[dim] //= tp.size
            offs[dim] = t * size[dim]
        if fsdp > 1:
            rows = size[0]
            chunk = -(-rows // fsdp)
            start = min(f * chunk, rows)
            offs[0], size[0] = offs[0] + start, min(start + chunk, rows) - start
        return leaf.box(offs, size)

    t_idx = train_coords(mesh).tp_index
    f_idx = mesh.get_local_rank("fsdp") if fsdp > 1 else 0
    mine = port_box(t_idx, f_idx)
    block = Block.of(param, dim, tp)
    if leaf.box(block.offsets, block.data.shape) != mine:
        raise RuntimeError(f"{leaf.path}: the parameter's layout is not FSDP2's rows of tp's block")
    split = [[] for _ in leaf.shape]
    for axis, n in (("tp", tp.size if dim is not None else 1), ("fsdp", fsdp)):
        varied = set()
        for c in range(n):
            other = port_box(c, f_idx) if axis == "tp" else port_box(t_idx, c)
            for which in (0, 1):
                varied |= {d for d in range(len(leaf.shape)) if other[which][d] != mine[which][d]}
        if len(varied) > 1:
            raise NotImplementedError(f"{leaf.path}: {axis} splits dims {sorted(varied)} of the leaf")
        for d in varied:
            split[d].append(axis)
    return _LeafLayout(mine[0], mine[1], [tuple(a) for a in split], leaf.shape)


class Adafactor:
    """optax's ``adafactor(lr)`` with its defaults, optionally after
    ``clip_by_global_norm``: per JAX leaf, (1) the factored second-moment
    scaling (decay ``1 − (count+1)^−0.8``, eps 1e-30 added to g², the two
    largest axes factored when the second is at least 128, no momentum, new
    statistics cast to the parameter's dtype), (2) ``clip_by_block_rms(1)``,
    (3) the learning rate, (4) ``scale_by_param_block_rms(1e-3)``, (5) the
    sign, then ``p + u`` in the parameter's dtype. No weight decay.

    **Leaves, not tensors.** optax sees the JAX model's leaves, stacked over
    layers (``nn.scan``: q/k/v ``[L, M, heads, D]``, o ``[L, H·D, M]``, the
    MLP ``[L, in, out]``), picks the factored axes from the leaf's shape and
    takes each block RMS over the whole leaf, all layers. So each step stacks
    the port's per-layer gradients into the leaf's layout
    (:func:`~pytorch_operator_tpu_torch.models.convert.jax_leaves`), computes
    the update there, and adds it back through the same mapping. The state
    holds optax's ``v_row``, ``v_col`` and ``v`` a leaf, with optax's shapes
    (a ``[1]`` placeholder for the unused ones).

    **Under a mesh** (``mesh``: the world's ``DeviceMesh``) each rank
    computes on its own part of each leaf (its tp blocks, FSDP2's rows of
    them: a box of the leaf) and holds the statistics of that part; no leaf
    is gathered. The row and column means sum this rank's part and
    all-reduce over the axes that split the dim they reduce; the two block
    RMS values all-reduce their sums of squares over the axes that split
    the leaf. ``state_dict`` gives each statistic as the
    ``sharding.Block`` of its part."""

    def __init__(self, model, lr: float, *, schedule: str, warmup_steps: int,
                 decay_steps, grad_clip: Optional[float], mesh=None):
        from ..models.convert import jax_leaves
        from ..parallel.sharding import tp_dim

        self.mesh = mesh
        self.tp = getattr(model, "tp", None)
        named = dict(model.named_parameters())
        self.leaves = []  # (JaxLeaf, its port parameters, its factored dims, _LeafLayout)
        covered = set()
        for leaf in jax_leaves(model.cfg):
            params = [named[n] for n in leaf.names]
            covered.update(leaf.names)
            layout = (_LeafLayout.of_whole(leaf.shape) if mesh is None
                      else _leaf_layout(leaf, params[0], leaf.names[0], self.tp, mesh))
            self.leaves.append((leaf, params, _factored_dims(leaf.shape), layout))
        missing = sorted(n for n, q in named.items() if q.requires_grad and n not in covered)
        if missing:
            raise ValueError(f"adafactor maps the Llama's JAX leaves only; not covered: {missing}")
        self.params = [q for _, ps, _, _ in self.leaves for q in ps]
        self.tp_split = [self.tp is not None and tp_dim(n) is not None
                         for leaf, _, _, _ in self.leaves for n in leaf.names]
        self.lr = lr
        self.schedule = dict(schedule=schedule, warmup_steps=warmup_steps, decay_steps=decay_steps)
        lr_at(0, lr, **self.schedule)  # validate the schedule name now
        self.grad_clip = grad_clip
        self.count = 0
        self.state = {}
        for leaf, ps, dims, lay in self.leaves:
            dtype, dev = ps[0].dtype, ps[0].device
            one = torch.zeros((1,), dtype=dtype, device=dev)
            if dims is None:
                st = {"v_row": one, "v_col": one.clone(),
                      "v": torch.zeros(lay.sizes, dtype=dtype, device=dev)}
            else:
                d1, d0 = dims
                st = {
                    "v_row": torch.zeros(np.delete(lay.sizes, d0).tolist(), dtype=dtype, device=dev),
                    "v_col": torch.zeros(np.delete(lay.sizes, d1).tolist(), dtype=dtype, device=dev),
                    "v": one,
                }
            self.state[leaf.path] = st

    def _mean(self, x: torch.Tensor, dims, lay: _LeafLayout, leaf_dims, keepdim: bool = False):
        """The mean of ``x`` (this rank's part, in the parameter's dtype)
        over its ``dims`` (leaf dims ``leaf_dims``) over the whole leaf:
        ``x.mean`` where no axis splits them, else the f32 sum all-reduced
        over the axes that do, divided by their whole extent, rounded to
        ``x``'s dtype as a mean of it is."""
        from ..parallel.collectives import psum

        axes = sorted({a for d in leaf_dims for a in lay.split[d]})
        if not axes:
            return x.mean(dims, keepdim=keepdim)
        total = x.float().sum(dims, keepdim=keepdim)
        for axis in axes:
            total = psum(total, axis, self.mesh)
        n = math.prod(lay.whole[d] for d in leaf_dims)
        return (total / n).to(x.dtype)

    @torch.no_grad()
    def step(self) -> None:
        from ..parallel.sharding import local_tensor

        if self.grad_clip is not None:
            clip_by_global_norm_([q.grad for q in self.params], self.grad_clip, self.tp_split, self.tp)
        t = torch.tensor(float(self.count + 1), dtype=torch.float32)
        decay_t = 1.0 - t.pow(-0.8)
        decay, keep_new = float(decay_t), float(1.0 - decay_t)
        lr = lr_at(self.count, self.lr, **self.schedule)
        for leaf, ps, dims, lay in self.leaves:
            g = leaf.from_port([local_tensor(q.grad) for q in ps], lay.sizes)
            p = leaf.from_port([local_tensor(q).detach() for q in ps], lay.sizes)
            st = self.state[leaf.path]
            dtype = p.dtype
            every = tuple(range(p.dim()))
            g_sq = g * g + _in_dtype(1e-30, dtype)
            if dims is not None:
                d1, d0 = dims
                v_row = (decay * st["v_row"].float() + keep_new * self._mean(g_sq, d0, lay, [d0]).float()).to(dtype)
                v_col = (decay * st["v_col"].float() + keep_new * self._mean(g_sq, d1, lay, [d1]).float()).to(dtype)
                st["v_row"], st["v_col"] = v_row, v_col
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_mean = self._mean(v_row, reduced_d1, lay, [d1], keepdim=True)
                row_factor = (v_row / row_mean).pow(-0.5)
                u = g * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
            else:
                v = (decay * st["v"].float() + keep_new * g_sq.float()).to(dtype)
                st["v"] = v
                u = g * v.pow(-0.5)
            u = u / torch.clamp_min(self._mean(u * u, every, lay, every).sqrt() / 1.0, 1.0)  # clip_by_block_rms(1)
            u = u * _in_dtype(lr, dtype)
            u = u * self._mean(p * p, every, lay, every).sqrt().clamp_min(_in_dtype(1e-3, dtype))  # param block rms
            for i, q in enumerate(ps):
                local_tensor(q).sub_(leaf.to_port(u, i))
                q.grad = None
        self.count += 1

    def _state_blocks(self, st: dict, dims, lay: _LeafLayout) -> dict:
        """Each statistic of one leaf as the ``sharding.Block`` of this
        rank's part: a factored statistic's offsets are the leaf part's less
        the reduced dim; a part is written by the lowest coordinate of the
        axes that do not split it."""
        from ..parallel.mesh import axis_sizes
        from ..parallel.sharding import Block

        sizes = axis_sizes(self.mesh)
        out = {}
        for key, t in st.items():
            if tuple(t.shape) == (1,) and (dims is not None) == (key == "v"):
                kept = []  # a placeholder: rank 0 writes it
            elif key == "v":
                kept = list(range(len(lay.whole)))
            else:
                kept = [d for d in range(len(lay.whole)) if d != dims[1 if key == "v_row" else 0]]
            axes = {a for d in kept for a in lay.split[d]}
            writer = all(self.mesh.get_local_rank(a) == 0 for a, n in sizes.items()
                          if n > 1 and a not in axes)
            if not kept:
                out[key] = Block(t, (0,), (1,), writer)
            else:
                out[key] = Block(t, tuple(lay.offsets[d] for d in kept),
                                 tuple(lay.whole[d] for d in kept), writer)
        return out

    def state_dict(self) -> dict:
        """The update count and optax's ``v_row``/``v_col``/``v`` by JAX leaf
        path; under a mesh each as the ``sharding.Block`` of this rank's
        part."""
        if self.mesh is None:
            return {"count": self.count, "adafactor": {k: dict(v) for k, v in self.state.items()}}
        return {"count": self.count, "adafactor": {
            leaf.path: self._state_blocks(self.state[leaf.path], dims, lay)
            for leaf, _, dims, lay in self.leaves
        }}

    def load_state_dict(self, state: dict) -> None:
        """Load :meth:`state_dict`'s values: this rank's parts, or (under a
        mesh) the whole statistics, of which it takes its part."""
        self.count = int(state["count"])
        blocks = self.state_dict()["adafactor"] if self.mesh is not None else None
        for path, st in state["adafactor"].items():
            for k, t in st.items():
                mine = self.state[path][k]
                if blocks is not None and tuple(t.shape) != tuple(mine.shape):
                    b = blocks[path][k]
                    if tuple(t.shape) == tuple(b.shape):
                        t = t[tuple(slice(o, o + n) for o, n in zip(b.offsets, mine.shape))]
                if tuple(t.shape) != tuple(mine.shape):
                    raise ValueError(
                        f"adafactor state {path}/{k} has shape {tuple(t.shape)}, expected "
                        f"{tuple(mine.shape)}"
                    )
                mine.copy_(t)

    def state_nbytes(self) -> int:
        """Bytes of the state tensors (the factored statistics) this rank
        holds."""
        return sum(t.nbytes for st in self.state.values() for t in st.values())


def make_optimizer(
    params,
    lr: float,
    *,
    schedule: str = "constant",
    warmup_steps: int = 0,
    decay_steps=None,
    grad_clip=None,
    weight_decay: float = 0.1,
    optimizer: str = "adamw",
    mesh=None,
):
    """The shared optimizer recipe: AdamW (weight decay ``weight_decay``) or
    adafactor (no weight decay, as in the JAX package), optional
    linear-warmup + cosine decay, optional global-norm clipping before
    either (see the JAX ``make_optimizer``). ``params`` is an iterable of
    parameters or the model; adafactor needs the model, whose JAX leaves
    decide its factored axes and block RMS. ``mesh``: the world's
    ``DeviceMesh`` the model is laid out on (adafactor's reductions run over
    its axes); a tensor-parallel model's layout is read from the model."""
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"optimizer={optimizer!r} not in ('adamw', 'adafactor')")
    if grad_clip is not None and grad_clip <= 0:
        raise ValueError(f"grad_clip must be positive, got {grad_clip}")
    sched = dict(schedule=schedule, warmup_steps=warmup_steps, decay_steps=decay_steps,
                 grad_clip=grad_clip)
    if optimizer == "adafactor":
        if not isinstance(params, torch.nn.Module):
            raise TypeError("optimizer='adafactor' needs the model, not its parameters")
        return Adafactor(params, lr, mesh=mesh, **sched)
    if isinstance(params, torch.nn.Module):
        tp = getattr(params, "tp", None)
        if tp is not None:
            from ..parallel.sharding import tp_dim

            named = list(params.named_parameters())
            return Optimizer([p for _, p in named], lr, weight_decay=weight_decay,
                             tp_dims=[tp_dim(n) for n, _ in named], tp=tp, **sched)
        params = params.parameters()
    return Optimizer(params, lr, weight_decay=weight_decay, **sched)


def make_lm_loss_fn(
    model, *, include_aux: bool = True, on_aux: Optional[Callable[[torch.Tensor], None]] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Next-token cross-entropy ``loss_fn(tokens [B,S] int64) -> scalar``:
    ``logits[:, :-1]`` against ``tokens[:, 1:]``, mean over tokens. With
    ``cfg.xent_impl="chunked"`` the model returns hidden states and the LM
    head is fused into the loss (ops/chunked_xent.py): no [B,S,V] logits
    tensor exists.

    A MoE model with ``cfg.moe_aux_weight > 0`` adds that weight times the
    mean over layers of its load-balance loss, unless ``include_aux`` is
    False (the held-out loss); ``on_aux`` then receives each call's aux value
    (detached, on the device).

    A tensor-parallel model's loss is ``vocab_parallel_xent`` over its
    head's block of columns: in 8192-column chunks for ``"chunked"``, in one
    chunk of the block for ``"dense"`` (the same value)."""
    chunked = model.cfg.xent_impl == "chunked"
    aux_w = model.cfg.moe_aux_weight if include_aux else 0.0
    tp = getattr(model, "tp", None)
    if tp is not None:
        from ..ops.chunked_xent import vocab_parallel_xent

        def tp_loss_fn(tokens):
            h = model(tokens, return_hidden=True)[:, :-1]
            w = model.head_kernel()
            return vocab_parallel_xent(
                h.reshape(-1, h.shape[-1]), w, tokens[:, 1:].reshape(-1), tp=tp,
                col_offset=model.vocab_offset, chunk=8192 if chunked else w.shape[1],
            ).mean()

        return tp_loss_fn

    def loss_fn(tokens):
        labels = tokens[:, 1:].reshape(-1)
        if aux_w > 0:
            out, aux = model(tokens, return_hidden=chunked, return_aux=True)
        else:
            out, aux = model(tokens, return_hidden=chunked), None
        if chunked:
            from ..ops.chunked_xent import chunked_softmax_xent

            h = out[:, :-1].reshape(-1, out.shape[-1])
            xent = chunked_softmax_xent(h, model.head_kernel(), labels).mean()
        else:
            xent = F.cross_entropy(out[:, :-1].reshape(-1, out.shape[-1]), labels)
        if aux is None:
            return xent
        if on_aux is not None:
            on_aux(aux.detach())
        return xent + aux_w * aux

    return loss_fn


def make_lm_eval_step(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """``eval_step(tokens) -> loss``: the training cross-entropy of
    :func:`make_lm_loss_fn` without gradients, without an update and without
    a MoE model's aux term (the reference's ``include_aux=False``), so
    ``exp`` of it is a perplexity."""
    loss_fn = make_lm_loss_fn(model, include_aux=False)

    @torch.no_grad()
    def eval_step(tokens):
        return loss_fn(tokens)

    return eval_step


def make_lm_train_step(model, optimizer, grad_accum: int = 1, on_aux=None):
    """``train_step(tokens) -> loss``: gradients of :func:`make_lm_loss_fn`
    and one optimizer update, in place (``on_aux`` as there, once a
    microbatch).

    ``grad_accum=N`` splits the batch into N sequential microbatches: their
    gradients are summed in f32 buffers (whatever the parameter dtype),
    divided by N and cast to each parameter's dtype before the one update;
    the loss is the mean of the microbatch losses."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    loss_fn = make_lm_loss_fn(model, on_aux=on_aux)
    params = optimizer.params

    def train_step(tokens):
        if grad_accum == 1:
            loss = loss_fn(tokens)
            loss.backward()
        else:
            B = tokens.shape[0]
            if B % grad_accum:
                raise ValueError(f"global batch {B} not divisible by grad_accum={grad_accum}")
            # Shaped and placed like each parameter: a DTensor buffer under
            # FSDP, added to the DTensor gradient shard by shard.
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for mb in tokens.split(B // grad_accum):
                mb_loss = loss_fn(mb)
                mb_loss.backward()
                loss = loss + mb_loss.detach()
                for a, p in zip(acc, params):
                    a.add_(p.grad)
                    p.grad = None
            loss = loss / grad_accum
            for a, p in zip(acc, params):
                p.grad = (a / grad_accum).to(p.dtype)
        optimizer.step()
        return loss.detach()

    return train_step


class ProgressHeartbeat:
    """The throttled steps/sec meter behind the live heartbeat:
    ``tick(step, loss_fn)`` fires at most every ``every_s`` seconds, calls
    ``loss_fn()`` (a real device fence), reports the rolling steps/sec over
    the interval less the time flagged by ``exclude()`` (checkpoint saves,
    which the final throughput excludes too), and returns the time spent
    reporting so the caller can exclude it. With ``report=None`` every call
    is a free no-op."""

    def __init__(self, report, every_s: float = 10.0, start_step: int = 0):
        self.report = report
        self.every_s = every_s
        self._t = time.time()
        self._step = start_step
        self._excl = 0.0

    def exclude(self, dt: float) -> None:
        self._excl += dt

    def tick(self, step: int, loss_fn) -> float:
        if self.report is None or time.time() - self._t < self.every_s:
            return 0.0
        loss = loss_fn()  # fences: all work queued through `step` is done
        now = time.time()
        interval = max((now - self._t) - self._excl, 1e-9)
        self.report(step, loss, (step - self._step) / interval)
        done = time.time()
        self._t, self._step, self._excl = done, step, 0.0
        return done - now  # report time only; the fence was real compute


def heartbeat_reporter(report_progress, *, batch=None, n_dev: int = 1, unit=None, feed=None):
    """The ``ProgressHeartbeat`` → ``report_progress`` adapter: maps (step,
    loss, steps/sec) into a heartbeat record with the interval's mean step
    time, given ``batch`` (items a step) the throughput per device, and given
    a ``feed`` with ``stats()`` (a device prefetcher) its recent stall a get
    (``feed_stall_ms_recent``: a burst moves the supervisor's
    ``feed_stall_dominance`` rule now, not after a lifetime average)."""

    def report(step, loss, sps):
        kw = {}
        if batch is not None:
            kw["throughput"] = sps * batch / max(n_dev, 1)
            kw["unit"] = unit or "items/sec/chip"
        if feed is not None:
            try:
                s = feed.stats()
                kw["feed_stall_ms"] = s.get("feed_stall_ms_recent", s["feed_stall_ms_avg"])
            except Exception:
                # invariant: waived — feed-stall telemetry must never kill the step loop
                pass
        report_progress(
            step, loss=loss, steps_per_sec=sps,
            step_time_ms=1000.0 / sps if sps > 0 else None, **kw,
        )

    return report


def throughput_loop(
    train_step,
    batches: Callable[[int], torch.Tensor],
    *,
    steps: int,
    warmup: int,
    on_first_step: Optional[Callable[[], None]] = None,
    checkpoint_every: int = 0,
    save: Optional[Callable[[int], None]] = None,
    start_step: int = 0,
    log=print,
    profile_dir: Optional[str] = None,
    progress=None,
    progress_every_s: float = 10.0,
):
    """Run ``max(warmup, 1)`` warmup steps, then ``steps`` timed ones.
    Returns ``(losses, steps_per_sec, end_step)`` with ``losses`` the loss
    tensor of every step, warmup included, in order.

    The first step includes the kernels' build. The warmup steps are outside
    the timed window, which opens after a fence and closes on
    ``float(loss)`` of the last step — a real device-to-host copy, so all
    queued work is inside it. In the timed loop, ``save(step)`` runs after
    every step whose count ``step`` is a multiple of ``checkpoint_every``,
    behind a fence; its time is excluded from the window and from the
    heartbeat. ``progress(step, loss, steps_per_sec)`` is the live heartbeat
    (see :class:`ProgressHeartbeat`); its report time is excluded from the
    window, its fence is not. Each timed step is an ``obs`` span ``step``
    and each save a span ``save``. ``profile_dir`` runs the timed window
    under :func:`maybe_profile`, each step inside a ``record_function("step")``
    (the step marker ``profiling.device_report`` counts); the window's time
    is taken before the trace is written."""
    step = start_step
    losses = []
    t0 = time.time()
    for i in range(max(warmup, 1)):
        losses.append(train_step(batches(step)))
        step += 1
        if i == 0:
            float(losses[-1])
            if on_first_step is not None:
                on_first_step()
            log(f"first step (kernel build included) +{time.time() - t0:.1f}s")
    float(losses[-1])

    t_excluded = 0.0
    with maybe_profile(profile_dir, log) as prof:
        t0 = time.time()
        hb = ProgressHeartbeat(progress, progress_every_s, start_step=step)
        for _ in range(steps):
            marker = (
                torch.profiler.record_function("step") if prof is not None
                else contextlib.nullcontext()
            )
            with obs.span("step", cat="step", step=step), marker:
                losses.append(train_step(batches(step)))
            step += 1
            if checkpoint_every and save is not None and step % checkpoint_every == 0:
                float(losses[-1])  # fence before leaving the hot loop
                t_save = time.time()
                with obs.span("save", cat="ckpt", step=step):
                    save(step)
                dt_save = time.time() - t_save
                t_excluded += dt_save
                hb.exclude(dt_save)
            t_excluded += hb.tick(step, lambda: float(losses[-1]))
        float(losses[-1])
        # Taken here, before the profiler writes its trace.
        dt = time.time() - t0 - t_excluded
    return losses, steps / dt, step


# ---- the image benches' shared parts (resnet_bench, vit_bench) ----


def average_gradients_(params, world: int) -> None:
    """Replace each parameter's ``.grad`` by its mean over the ``world``
    ranks of the joined world (data parallelism over whole parameters, as
    the image benches' dp mesh: each rank's loss is the mean over its equal
    share of the global batch, so the mean of the gradients is the global
    batch's). One flat all-reduce a gradient dtype; a no-op in a world of
    one."""
    if world == 1:
        return
    import torch.distributed as dist

    grads = [p.grad for p in params if p.grad is not None]
    for dtype in sorted({g.dtype for g in grads}, key=str):
        group = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat)
        flat /= world
        offset = 0
        for g in group:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def probe_image_file(data_file: str):
    """Pre-model geometry probe: ``(meta, x_field_or_None)``, the one place
    both benches read the image shape from a packed file (full validation is
    :func:`open_image_feed`'s, which takes the probed meta)."""
    from ..data import read_meta

    meta = read_meta(data_file)
    return meta, next((f for f in meta.fields if f.name == "x"), None)


def open_image_feed(
    data_file: str,
    *,
    batch: int,
    chunk: int,
    classes: int,
    device,
    square: bool = False,
    seed: int = 0,
    meta=None,
    prefetch: int = 0,
    prefetch_depth_max: int = 0,
    autotune: bool = False,
    prefetch_workers: int = 0,
):
    """Validate and open a packed image file; return ``(next_batches,
    loader)``, the real-data feed both image benches share (the JAX
    function's protocol).

    ``next_batches()`` returns ``chunk`` loader batches of the global
    ``batch``, stacked ``[chunk, rows, H, W, C]`` bf16 images and ``[chunk,
    rows]`` int64 labels on ``device``, ``rows`` this rank's share (each rank
    of a world draws the same global batches from the same seed and keeps
    its rows). The loader lends zero-copy views of a reused slot, so the copy
    into the stacked buffers is mandatory. Refused up front: a file without
    ``x`` and ``y`` fields or whose ``x`` is not H×W×C; with ``square``, H ≠
    W (ViT's position embeddings); fewer records than the batch; and, by a
    whole-file scan, any label outside ``[0, classes)`` (a one-hot of it
    would be all zeros and deflate the loss). The caller closes ``loader``;
    with ``prefetch > 0`` it is the device prefetcher's facade (closing it
    closes the loader too) and the pulls, the stacking cast and the copy to
    the card run on the feed's threads (``data/device_prefetch.py``)."""
    from ..data import field_range, open_training_loader, read_meta
    from ..data.device_prefetch import DevicePrefetcher, to_device
    from ..parallel.collectives import world as joined_world

    if meta is None:
        meta = read_meta(data_file)
    names = [f.name for f in meta.fields]
    if "x" not in names or "y" not in names:
        raise ValueError(
            f"--data-file needs fields named 'x' (images) and 'y' (labels); "
            f"{data_file} has {names} (pack with pytorch_operator_tpu_torch.data.pack)"
        )
    field_x = next(f for f in meta.fields if f.name == "x")
    if len(field_x.shape) != 3:
        raise ValueError(f"--data-file 'x' records must be HxWxC images; got shape {field_x.shape}")
    if square and field_x.shape[0] != field_x.shape[1]:
        raise ValueError(
            f"--data-file images must be square (H == W) for this model; "
            f"got {field_x.shape[0]}x{field_x.shape[1]}"
        )
    if meta.n_records < batch:
        raise ValueError(f"--data-file holds {meta.n_records} records < global batch {batch}")
    lo, hi = field_range(data_file, meta, "y")
    if int(lo) < 0 or int(hi) >= classes:
        raise ValueError(
            f"--data-file labels span [{int(lo)}, {int(hi)}] but the model "
            f"head has {classes} classes (pass --classes)"
        )
    rank, world = joined_world()
    rows = slice(rank * batch // world, (rank + 1) * batch // world)
    loader = open_training_loader(data_file, batch, seed=seed, processes=world)

    def host_batches():
        # The serial half (the loader's borrow contract): pulls and
        # same-dtype copies out of the slot, this rank's rows only.
        raw = []
        for _ in range(chunk):
            _, _, fields = loader.next_batch()
            raw.append((np.array(fields["x"][rows], copy=True), np.array(fields["y"][rows], copy=True)))
        return raw

    def stacked(raw):
        # The half that may run on several feed threads: stack, cast to bf16.
        sx = torch.from_numpy(np.stack([x for x, _ in raw])).to(torch.bfloat16)
        sy = torch.from_numpy(np.stack([y for _, y in raw]).astype(np.int64))
        return sx, sy

    if prefetch > 0:
        pf = DevicePrefetcher(
            host_batches,
            put=lambda raw: to_device(stacked(raw), device),
            depth=prefetch,
            depth_max=prefetch_depth_max or None,
            workers=max(prefetch_workers, 1),
            autotune=autotune,
        )

        class _Feed:
            """Caller-owned close handle: the prefetcher first, then the loader."""

            def stats(self):
                return pf.stats()

            def close(self):
                pf.close()
                loader.close()

        return pf.get, _Feed()

    def next_batches():
        return tuple(t.to(device) for t in stacked(host_batches()))

    return next_batches, loader


def window_progress(report_progress, *, steps: int, batch: int, n_dev: int, unit: str):
    """The image benches' per-window live meter: maps :func:`timed_windows`'
    ``(windows_done, windows_measured, dt)`` into a progress record."""

    def progress(done, measured, dt):
        report_progress(
            done * steps,
            steps_per_sec=measured * steps / dt,
            throughput=batch * measured * steps / dt / n_dev,
            unit=unit,
        )

    return progress


def timed_windows(run_window, fence, *, windows, profile_dir=None, log=print, progress=None):
    """The image benches' two protocols (the JAX function's):

    - A: fenced windows, the fastest kept (skipped when ``windows == 1``,
      identical to B then, or when profiling, so that the trace shows the
      headline run alone);
    - B (the headline): the same number of windows with depth-1 lookahead:
      window i-1's token is fenced after window i is enqueued, so the card
      never waits on a fence while the host runs at most one window ahead.

    ``run_window()`` enqueues one window and returns a fence token;
    ``fence(token)`` is a real device-to-host read of it. Returns
    ``(dt_min_window | None, dt_sustained_total, n_win)``. ``progress``, when
    given, is called after every fenced window and once after the sustained
    run with the aggregate. Every window trains the same state."""
    n_win = max(windows, 1)
    dt = math.inf
    wins_done = 0
    if not profile_dir and n_win > 1:
        for _ in range(n_win):
            t0 = time.time()
            fence(run_window())
            dt_w = time.time() - t0
            dt = min(dt, dt_w)
            wins_done += 1
            if progress is not None:
                progress(wins_done, 1, dt_w)
    with maybe_profile(profile_dir, log):
        t0 = time.time()
        prev = None
        for _ in range(n_win):
            tok = run_window()
            if prev is not None:
                fence(prev)
            prev = tok
        fence(prev)
        # Taken here, before the profiler writes its trace.
        dt_sustained = time.time() - t0
    wins_done += n_win
    if progress is not None:
        progress(wins_done, n_win, dt_sustained)
    if not math.isfinite(dt):
        dt = None if profile_dir else dt_sustained / n_win
    return dt, dt_sustained, n_win


def chunk_plan(steps: int, warmup: int) -> tuple:
    """``(chunk, steps, warm_chunks)`` as the JAX image benches fuse steps:
    chunks of ``min(30, steps)`` steps, the timed steps rounded up to whole
    chunks, the warmup rounded to whole chunks (at least one)."""
    chunk = min(30, max(steps, 1))
    steps = math.ceil(max(steps, 1) / chunk) * chunk
    return chunk, steps, max(1, round(max(warmup, 1) / chunk))


def image_bench_loop(train_step, next_batches, *, steps: int, warmup: int, windows: int,
                     batch: int, world: int, profile_dir=None, tag: str, log=print):
    """Warm up, then time ``windows`` windows of ``steps`` steps by
    :func:`timed_windows`: the loop both image benches share. A chunk is
    ``chunk`` steps (:func:`chunk_plan`), each on its own batch of
    ``next_batches()`` (stacked ``[chunk, rows, ...]``, or one pair that the
    synthetic mode reuses), each ``train_step(x, y) -> loss`` (a device
    tensor). The first chunk's end is read back and reported as the first
    step. Returns ``dict(dt, dt_sustained, n_win, steps, losses)``:
    ``losses`` every step's loss in order, warmup included (kept on the
    device and read back at the end, so no step waits on the host)."""
    from ..runtime import rendezvous

    chunk, steps, warm_chunks = chunk_plan(steps, warmup)
    losses = []

    def run_chunk():
        bxs, bys = next_batches()
        stacked = bxs.dim() == 5
        for i in range(chunk):
            losses.append(train_step(bxs[i], bys[i]) if stacked else train_step(bxs, bys))
        return losses[-1]

    t_start = time.time()
    for i in range(warm_chunks):
        loss = run_chunk()
        if i == 0:
            float(loss)
            rendezvous.report_first_step(0)
            log(f"[{tag}] first chunk ({chunk} steps, kernel build included) +{time.time() - t_start:.1f}s")
    float(loss)
    if profile_dir and windows > 1:
        log(f"[{tag}] --profile-dir set: timing a single window")
        windows = 1

    def run_window():
        for _ in range(steps // chunk):
            run_chunk()
        return losses[-1]

    dt, dt_sustained, n_win = timed_windows(
        run_window, lambda tok: float(tok), windows=windows, profile_dir=profile_dir,
        log=lambda m: log(f"[{tag}] {m}"),
        progress=window_progress(rendezvous.report_progress, steps=steps, batch=batch,
                                 n_dev=world, unit="images/sec/chip"),
    )
    return dict(dt=dt, dt_sustained=dt_sustained, n_win=n_win, steps=steps,
                losses=[float(x) for x in losses])
