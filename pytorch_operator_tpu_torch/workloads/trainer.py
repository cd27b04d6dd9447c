"""The training loop's shared parts — the port of what the LM path uses from
``pytorch_operator_tpu/workloads/trainer.py``.

- :func:`make_optimizer`: AdamW with optax's defaults (b1 0.9, b2 0.999,
  eps 1e-8, decoupled weight decay on every parameter), an optional linear
  warmup + cosine decay read at the step count before the update, and an
  optional global-norm clip written as optax's ``clip_by_global_norm``.
- :func:`make_lm_loss_fn` / :func:`make_lm_train_step` /
  :func:`make_lm_eval_step`: next-token cross-entropy (dense f32 logits, or
  the chunked-vocab loss), one step of it with optional gradient
  accumulation summed in f32, and the held-out loss without gradients.
- :class:`ProgressHeartbeat`, :func:`heartbeat_reporter` and
  :func:`throughput_loop`: the timed loop, its checkpoint saves and its live
  heartbeat.

PyTorch runs eagerly, so there is no jit: the model and the optimizer hold
the state, and ``train_step(tokens)`` updates both in place and returns the
loss as a device tensor. Not ported here: adafactor (raises), pipeline
parallelism and MoE aux losses, profiling, and the flight recorder's step
spans.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F


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
) -> Optimizer:
    """The shared optimizer recipe: AdamW, optional linear-warmup + cosine
    decay, optional global-norm clipping (see the JAX ``make_optimizer``)."""
    if optimizer == "adafactor":
        raise NotImplementedError(
            "optimizer='adafactor' is not ported yet (ROADMAP.md: adafactor)"
        )
    if optimizer != "adamw":
        raise ValueError(f"optimizer={optimizer!r} not in ('adamw', 'adafactor')")
    if grad_clip is not None and grad_clip <= 0:
        raise ValueError(f"grad_clip must be positive, got {grad_clip}")
    return Optimizer(
        params, lr, schedule=schedule, warmup_steps=warmup_steps,
        decay_steps=decay_steps, grad_clip=grad_clip, weight_decay=weight_decay,
    )


def make_lm_loss_fn(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """Next-token cross-entropy ``loss_fn(tokens [B,S] int64) -> scalar``:
    ``logits[:, :-1]`` against ``tokens[:, 1:]``, mean over tokens. With
    ``cfg.xent_impl="chunked"`` the model returns hidden states and the LM
    head is fused into the loss (ops/chunked_xent.py): no [B,S,V] logits
    tensor exists."""
    chunked = model.cfg.xent_impl == "chunked"

    def loss_fn(tokens):
        labels = tokens[:, 1:].reshape(-1)
        if chunked:
            from ..ops.chunked_xent import chunked_softmax_xent

            hidden = model(tokens, return_hidden=True)
            h = hidden[:, :-1].reshape(-1, hidden.shape[-1])
            return chunked_softmax_xent(h, model.head_kernel(), labels).mean()
        logits = model(tokens)
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), labels)

    return loss_fn


def make_lm_eval_step(model) -> Callable[[torch.Tensor], torch.Tensor]:
    """``eval_step(tokens) -> loss``: the training cross-entropy of
    :func:`make_lm_loss_fn` without gradients and without an update (the
    model has no MoE aux term to drop), so ``exp`` of it is a perplexity."""
    loss_fn = make_lm_loss_fn(model)

    @torch.no_grad()
    def eval_step(tokens):
        return loss_fn(tokens)

    return eval_step


def make_lm_train_step(model, optimizer: Optimizer, grad_accum: int = 1):
    """``train_step(tokens) -> loss``: gradients of :func:`make_lm_loss_fn`
    and one optimizer update, in place.

    ``grad_accum=N`` splits the batch into N sequential microbatches: their
    gradients are summed in f32 buffers (whatever the parameter dtype),
    divided by N and cast to each parameter's dtype before the one update;
    the loss is the mean of the microbatch losses."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    loss_fn = make_lm_loss_fn(model)
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


def heartbeat_reporter(report_progress, *, batch=None, n_dev: int = 1, unit=None):
    """The ``ProgressHeartbeat`` → ``report_progress`` adapter: maps (step,
    loss, steps/sec) into a heartbeat record with the interval's mean step
    time and, given ``batch`` (items a step), the throughput per device."""

    def report(step, loss, sps):
        kw = {}
        if batch is not None:
            kw["throughput"] = sps * batch / max(n_dev, 1)
            kw["unit"] = unit or "items/sec/chip"
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
    window, its fence is not."""
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
    t0 = time.time()
    hb = ProgressHeartbeat(progress, progress_every_s, start_step=step)
    for _ in range(steps):
        losses.append(train_step(batches(step)))
        step += 1
        if checkpoint_every and save is not None and step % checkpoint_every == 0:
            float(losses[-1])  # fence before leaving the hot loop
            t_save = time.time()
            save(step)
            dt_save = time.time() - t_save
            t_excluded += dt_save
            hb.exclude(dt_save)
        t_excluded += hb.tick(step, lambda: float(losses[-1]))
    float(losses[-1])
    dt = time.time() - t0 - t_excluded
    return losses, steps / dt, step
