"""The training loop's shared parts — the port of what the LM path uses from
``pytorch_operator_tpu/workloads/trainer.py``.

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

PyTorch runs eagerly, so there is no jit: the model and the optimizer hold
the state, and ``train_step(tokens)`` updates both in place and returns the
loss as a device tensor. Not ported here: pipeline parallelism (ROADMAP.md
item 3b, multi-GPU).
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


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: ``g · max_norm / ‖g‖`` when
    ``‖g‖ >= max_norm``, unchanged otherwise, with no epsilon (unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the global norm (a device
    scalar; no host sync)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


class Optimizer:
    """AdamW over ``params`` with the schedule and clip of
    :func:`make_optimizer`. ``step()`` reads each parameter's ``.grad``,
    updates the parameters in place and clears the gradients."""

    def __init__(self, params, lr: float, *, schedule: str, warmup_steps: int,
                 decay_steps, grad_clip: Optional[float], weight_decay: float):
        self.params = [p for p in params if p.requires_grad]
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
            clip_by_global_norm_([p.grad for p in self.params], self.grad_clip)
        for group in self.adamw.param_groups:
            group["lr"] = lr_at(self.count, self.lr, **self.schedule)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        """The optimizer state a checkpoint carries: the update count (the
        schedule's step, optax's ``count``) and AdamW's moments and
        bias-correction steps."""
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])

    def state_nbytes(self) -> int:
        """Bytes of the optimizer's state tensors (AdamW: two moments a
        parameter, 2N f32, and a step scalar a parameter)."""
        return sum(
            t.nbytes for st in self.adamw.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)
        )


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
    (a ``[1]`` placeholder for the unused ones)."""

    def __init__(self, model, lr: float, *, schedule: str, warmup_steps: int,
                 decay_steps, grad_clip: Optional[float]):
        from ..models.convert import jax_leaves

        named = dict(model.named_parameters())
        self.leaves = []  # (JaxLeaf, its port parameters, its factored dims)
        covered = set()
        for leaf in jax_leaves(model.cfg):
            params = [named[n] for n in leaf.names]
            covered.update(leaf.names)
            self.leaves.append((leaf, params, _factored_dims(leaf.shape)))
        missing = sorted(n for n, q in named.items() if q.requires_grad and n not in covered)
        if missing:
            raise ValueError(f"adafactor maps the Llama's JAX leaves only; not covered: {missing}")
        self.params = [q for _, ps, _ in self.leaves for q in ps]
        self.lr = lr
        self.schedule = dict(schedule=schedule, warmup_steps=warmup_steps, decay_steps=decay_steps)
        lr_at(0, lr, **self.schedule)  # validate the schedule name now
        self.grad_clip = grad_clip
        self.count = 0
        self.state = {}
        for leaf, ps, dims in self.leaves:
            dtype, dev = ps[0].dtype, ps[0].device
            one = torch.zeros((1,), dtype=dtype, device=dev)
            if dims is None:
                st = {"v_row": one, "v_col": one.clone(),
                      "v": torch.zeros(leaf.shape, dtype=dtype, device=dev)}
            else:
                d1, d0 = dims
                st = {
                    "v_row": torch.zeros(np.delete(leaf.shape, d0).tolist(), dtype=dtype, device=dev),
                    "v_col": torch.zeros(np.delete(leaf.shape, d1).tolist(), dtype=dtype, device=dev),
                    "v": one,
                }
            self.state[leaf.path] = st

    @torch.no_grad()
    def step(self) -> None:
        if self.grad_clip is not None:
            clip_by_global_norm_([q.grad for q in self.params], self.grad_clip)
        t = torch.tensor(float(self.count + 1), dtype=torch.float32)
        decay_t = 1.0 - t.pow(-0.8)
        decay, keep_new = float(decay_t), float(1.0 - decay_t)
        lr = lr_at(self.count, self.lr, **self.schedule)
        for leaf, ps, dims in self.leaves:
            g = leaf.from_port([q.grad for q in ps])
            p = leaf.from_port([q.detach() for q in ps])
            st = self.state[leaf.path]
            dtype = p.dtype
            g_sq = g * g + _in_dtype(1e-30, dtype)
            if dims is not None:
                d1, d0 = dims
                v_row = (decay * st["v_row"].float() + keep_new * g_sq.mean(d0).float()).to(dtype)
                v_col = (decay * st["v_col"].float() + keep_new * g_sq.mean(d1).float()).to(dtype)
                st["v_row"], st["v_col"] = v_row, v_col
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)).pow(-0.5)
                u = g * row_factor.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
            else:
                v = (decay * st["v"].float() + keep_new * g_sq.float()).to(dtype)
                st["v"] = v
                u = g * v.pow(-0.5)
            u = u / torch.clamp_min((u * u).mean().sqrt() / 1.0, 1.0)  # clip_by_block_rms(1)
            u = u * _in_dtype(lr, dtype)
            u = u * (p * p).mean().sqrt().clamp_min(_in_dtype(1e-3, dtype))  # param block rms
            for i, q in enumerate(ps):
                q.sub_(leaf.to_port(u, i))
                q.grad = None
        self.count += 1

    def state_dict(self) -> dict:
        """The update count and optax's ``v_row``/``v_col``/``v`` by JAX leaf
        path."""
        return {"count": self.count, "adafactor": {k: dict(v) for k, v in self.state.items()}}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for path, st in state["adafactor"].items():
            for k, t in st.items():
                mine = self.state[path][k]
                if tuple(t.shape) != tuple(mine.shape):
                    raise ValueError(
                        f"adafactor state {path}/{k} has shape {tuple(t.shape)}, expected "
                        f"{tuple(mine.shape)}"
                    )
                mine.copy_(t)

    def state_nbytes(self) -> int:
        """Bytes of the state tensors (the factored statistics)."""
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
):
    """The shared optimizer recipe: AdamW (weight decay ``weight_decay``) or
    adafactor (no weight decay, as in the JAX package), optional
    linear-warmup + cosine decay, optional global-norm clipping before
    either (see the JAX ``make_optimizer``). ``params`` is an iterable of
    parameters or the model; adafactor needs the model, whose JAX leaves
    decide its factored axes and block RMS."""
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"optimizer={optimizer!r} not in ('adamw', 'adafactor')")
    if grad_clip is not None and grad_clip <= 0:
        raise ValueError(f"grad_clip must be positive, got {grad_clip}")
    sched = dict(schedule=schedule, warmup_steps=warmup_steps, decay_steps=decay_steps,
                 grad_clip=grad_clip)
    if optimizer == "adafactor":
        if not isinstance(params, torch.nn.Module):
            raise TypeError("optimizer='adafactor' needs the model, not its parameters")
        return Adafactor(params, lr, **sched)
    if isinstance(params, torch.nn.Module):
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
    (detached, on the device)."""
    chunked = model.cfg.xent_impl == "chunked"
    aux_w = model.cfg.moe_aux_weight if include_aux else 0.0

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
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
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
