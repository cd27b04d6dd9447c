"""Pipeline parallelism over the ``pp`` mesh axis — the port of
``pytorch_operator_tpu/parallel/pipeline.py``.

JAX runs the whole pipeline as one SPMD program under ``shard_map``. Here
each stage is a process (its coordinate on the mesh's ``pp`` axis) that
holds its stage's parameters, and a Python loop walks JAX's tick plan:

- :func:`pipeline_apply`: ``M + P − 1`` ticks; at tick t stage s forwards
  microbatch ``t − s``, activations hop i → i+1
  (``collectives.neighbour_exchange``), and the microbatch the last stage
  finishes, ``t − (P−1)``, is broadcast to every stage.
- :func:`pipeline_value_and_grad`, ``schedule="1f1b"``: ``M + 2(P−1)``
  ticks; stage s forwards microbatch ``t − s`` and backwards microbatch
  ``t − 2(P−1) + s``, the cotangents hopping i → i−1 in the same exchange.
  A ring of depth 2P holds each in-flight microbatch's state, at slot
  ``j mod 2P``: with ``backward="stored"`` its autograd graph (the stage
  input as a leaf, and the output), backwarded by
  ``torch.autograd.backward(y, cot)`` at its backward tick and dropped
  then; with ``"recompute"`` its detached input, the stage rerun under
  autograd at that tick. ``schedule="gpipe"`` is JAX's
  ``value_and_grad`` through the forward: the forward ticks keeping every
  microbatch's graph (all M), then the reverse ticks (stage s backwards
  microbatch ``t − s`` at reverse tick t).
- The loss of the microbatch that finishes at tick t runs that tick: at the
  last stage, or with ``sharded_loss=True`` on every stage over the last
  stage's output broadcast to all, where the loss's gradient with respect
  to it is summed over pp (``collectives.tp_enter``: JAX's psum transpose).
- Gradients accumulate over the microbatches in each parameter's ``.grad``,
  in its dtype, and are divided by M at the end (JAX l.562-566, 627).

Every rank takes part in every exchange and collective of every tick,
bubble ticks included (it computes nothing where it has no valid
microbatch and sends zeros), so the ranks stay in lock-step. A direction no
rank uses at a tick (the last tick's hops, the activations during GPipe's
backward) is skipped on all of them. A stage's own collectives (tp's,
ep's, inside ``fn`` and its stored backward) rely on the same plan: the
ranks of such a group share one pp index ``s``, so they skip the same
bubble ticks and forward and backward the same microbatch at each tick.

Deliberate differences from JAX:

- **Where the streams live.** JAX shards the input and output microbatch
  streams over pp (microbatch j with owner ``j // (M/P)``) and moves them
  with masked psums each tick. Here the pp ranks of one data coordinate
  hold the same rows: stage 0 reads the input ``x`` (the other stages
  need only its shape and dtype, e.g. an expanded empty tensor), the input
  cotangent comes back on stage 0 (None elsewhere), and
  :func:`pipeline_apply`'s output is on every stage. JAX's checks and
  messages are kept, ``M % P`` included, so the same configurations are
  accepted and refused.
- ``stage_params`` (and, with ``sharded_loss``, ``loss_params``) lead with
  the stage axis, all P stages' slices (JAX's layout: this rank takes slice
  s) or only this rank's (a leading axis of 1, the slice a device sees in
  ``shard_map``); or None, where ``fn`` holds its parameters itself (a
  module's: their gradients are left in ``.grad``, undivided, for the
  caller).
- :func:`pipeline_apply` runs without autograd: its gradient is
  :func:`pipeline_value_and_grad` with ``schedule="gpipe"``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .collectives import axis_index, axis_size, broadcast, neighbour_exchange, psum, tp_enter

BACKWARDS = ("recompute", "stored")
SCHEDULES = ("gpipe", "1f1b")


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return type(tree)(_map(fn, v) for v in tree)


def check_split(batch: int, M: int, P: int) -> None:
    """JAX's checks, in its order and with its messages, that a batch of
    ``batch`` rows splits into ``M`` microbatches over ``P`` stages."""
    if M < 1:
        raise ValueError("microbatches must be >= 1")
    if batch % M:
        raise ValueError(f"batch {batch} not divisible into {M} microbatches")
    if M % P:
        raise ValueError(
            f"microbatches {M} not divisible by pp extent {P} "
            "(the microbatch stream is sharded over pp)"
        )


def _stage_slice(tree, P: int, s: int, what: str):
    """This stage's slice of ``tree`` (None stays None): each leaf's entry
    ``s`` of a leading axis of P, or entry 0 of a leading axis of 1; other
    leading extents raise JAX's error."""
    if tree is None:
        return None
    lead = {leaf.shape[0] if leaf.dim() else None for leaf in _leaves(tree)}
    if lead not in ({P}, {1}):
        if what == "stage":
            raise ValueError(f"stage_params leading axes {lead} != pp extent {P}")
        raise ValueError(
            f"sharded_loss=True: loss_params leading axes {lead} != "
            f"pp extent {P} (every leaf must be stage-chunked)"
        )
    i = s if lead == {P} else 0
    return _map(lambda leaf: leaf[i], tree)


class _Stage:
    """One stage's forwards and backwards of ``fn(params, act)``, and the
    state each in-flight microbatch keeps (``keep="graph"``: its input leaf
    and output; ``"input"``: its detached input) in a ring of ``depth``
    slots, microbatch j at slot ``j mod depth``."""

    def __init__(self, fn, params, depth: int):
        self.fn, self.params = fn, params
        self.ring = [None] * depth

    def forward(self, j: int, inp, keep: Optional[str]):
        if keep is None:
            with torch.no_grad():
                return self.fn(self.params, inp)
        slot = j % len(self.ring)
        if self.ring[slot] is not None:
            raise RuntimeError(f"pipeline ring slot {slot} still holds microbatch {self.ring[slot][0]}")
        if keep == "input":
            with torch.no_grad():
                y = self.fn(self.params, inp)
            self.ring[slot] = (j, inp.detach(), None)
        else:
            leaf = inp.detach().requires_grad_()
            with torch.enable_grad():
                y = self.fn(self.params, leaf)
            self.ring[slot] = (j, leaf, y)
            y = y.detach()
        return y

    def backward(self, j: int, cot):
        """Backward microbatch j with its output's cotangent ``cot``; its
        state is dropped. Returns the input's cotangent."""
        slot = j % len(self.ring)
        held, self.ring[slot] = self.ring[slot], None
        if held is None or held[0] != j:
            raise RuntimeError(f"pipeline ring slot {slot} does not hold microbatch {j}")
        _, leaf, y = held
        if y is None:  # "recompute": the stage again, from its input
            leaf.requires_grad_()
            with torch.enable_grad():
                y = self.fn(self.params, leaf)
        torch.autograd.backward(y, cot)
        return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


class _Tail:
    """The loss of each microbatch as it leaves the last stage, and its
    backward: ``tail(j, y)`` (``y`` this stage's output this tick) returns
    the loss's cotangent of microbatch j's output on the last stage, None
    elsewhere or where j is not a microbatch. The loss parameters' gradients
    accumulate in their ``.grad``; :attr:`total` sums the losses (f32)."""

    def __init__(self, loss_fn, lp, targets, mb: int, M: int, sharded: bool, axis: str, mesh,
                 s: int, last: int, device):
        self.loss_fn, self.lp, self.targets, self.mb, self.M = loss_fn, lp, targets, mb, M
        self.sharded, self.axis, self.mesh, self.s, self.last = sharded, axis, mesh, s, last
        self.total = torch.zeros((), dtype=torch.float32, device=device)

    def __call__(self, j: int, y):
        if not 0 <= j < self.M:
            return None
        tgt = self.targets[j * self.mb:(j + 1) * self.mb]
        if self.sharded:
            yb = broadcast(y, self.axis, self.mesh, src=self.last).requires_grad_()
            with torch.enable_grad():
                lval = self.loss_fn(self.lp, tp_enter(yb, self.axis, self.mesh), tgt)
        elif self.s == self.last:
            yb = y.detach().requires_grad_()
            with torch.enable_grad():
                lval = self.loss_fn(self.lp, yb, tgt)
        else:
            return None
        torch.autograd.backward(lval)
        self.total += lval.detach().float()
        return yb.grad if self.s == self.last else None


def pipeline_apply(fn: Callable, stage_params, x, *, mesh, microbatches: int, axis: str = "pp"):
    """``y = fn(params_{P-1}, fn(..., fn(params_0, x)))`` as a pipeline over
    ``axis``, without autograd: ``fn(params, act) -> act`` is one stage and
    keeps the activation's shape and dtype; ``x`` ``[B, ...]`` splits into
    ``microbatches`` microbatches of ``B/M`` rows (``B % M == 0``, ``M % P
    == 0``). Returns the output ``[B, ...]`` on every rank of ``axis``."""
    P, s = axis_size(axis, mesh), axis_index(axis, mesh)
    last, M = P - 1, microbatches
    check_split(x.shape[0], M, P)
    params = _stage_slice(stage_params, P, s, "stage")
    mb = x.shape[0] // M
    zero = torch.zeros(x[:mb].shape, dtype=x.dtype, device=x.device)
    stage = _Stage(fn, params, 1)
    outs, act_in = [], None
    T = M + last
    for t in range(T):
        jf = t - s
        if 0 <= jf < M:
            y = stage.forward(jf, x[jf * mb:(jf + 1) * mb] if s == 0 else act_in, None)
        else:
            y = zero
        if 0 <= t - last < M:
            outs.append(broadcast(y, axis, mesh, src=last))
        if t < T - 1:
            act_in, _ = neighbour_exchange(y, None, axis, mesh)
    return torch.cat(outs)


def pipeline_value_and_grad(
    fn: Callable,
    loss_fn: Callable,
    stage_params,
    loss_params,
    x,
    targets,
    *,
    mesh,
    microbatches: int,
    axis: str = "pp",
    schedule: str = "1f1b",
    sharded_loss: bool = False,
    backward: str = "recompute",
    on_last_backward: Optional[Callable[[], None]] = None,
):
    """``(loss, (d_stage_params, d_loss_params, dx))`` of

        L = mean_j loss_fn(loss_params, fn(params_{P-1}, ... fn(params_0,
            x_j)), targets_j)

    over the ``microbatches`` microbatches j, as JAX's function (the module
    docstring for the schedules and the layout). ``loss_fn(lp, y_mb,
    target_mb) -> scalar`` is the mean over one microbatch. With
    ``sharded_loss=False`` it runs on the last stage; with True on every
    stage, ``lp`` this stage's chunk, and it must combine its partials over
    ``axis`` (``collectives.tp_leave`` for a sum whose gradient passes to
    each rank's part unchanged, ``pmax``) into the same scalar on every
    stage.

    Returns on every rank the loss and this stage's ``d_stage_params``
    (shaped as ``stage_params``; None for None); ``d_loss_params`` this
    stage's chunks' with ``sharded_loss``, else the last stage's, summed
    over ``axis`` so that every rank holds it (None for None); ``dx``
    ``[B, ...]`` on stage 0, None elsewhere. All are divided by M, and
    ``d_stage_params`` is also left in the leaves' ``.grad``.

    ``backward`` (1f1b only) picks what the ring holds: ``"stored"`` each
    in-flight microbatch's autograd graph (no recompute, GPipe's FLOPs),
    ``"recompute"`` its stage input (the stage rerun at the backward tick).
    ``on_last_backward`` runs right before this rank's last stage backward
    of the schedule (FSDP2's gradient-sync switch)."""
    if backward not in BACKWARDS:
        raise ValueError(f"backward={backward!r} not in ('recompute', 'stored')")
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r} not in ('gpipe', '1f1b')")
    P, s = axis_size(axis, mesh), axis_index(axis, mesh)
    last, M = P - 1, microbatches

    def loss_slice():
        return _stage_slice(loss_params, P, s, "loss") if sharded_loss else loss_params

    # JAX checks GPipe's loss chunks before the split, 1F1B's after it.
    lp = loss_slice() if schedule == "gpipe" else None
    check_split(x.shape[0], M, P)
    params = _stage_slice(stage_params, P, s, "stage")
    if schedule == "1f1b":
        lp = loss_slice()
    for leaf in _leaves(stage_params) + _leaves(loss_params):
        leaf.grad = None
    mb = x.shape[0] // M
    zero = torch.zeros(x[:mb].shape, dtype=x.dtype, device=x.device)
    tail = _Tail(loss_fn, lp, targets, mb, M, sharded_loss, axis, mesh, s, last, x.device)
    dxs = [None] * M

    def x_mb(j):
        return x[j * mb:(j + 1) * mb]

    def back(stage, j, cot, final: bool):
        if final and on_last_backward is not None:
            on_last_backward()
        dx = stage.backward(j, cot)
        if s == 0:
            dxs[j] = dx
        return dx

    act_in = cot_in = None
    if schedule == "1f1b":
        stage = _Stage(fn, params, 2 * P)  # JAX's ring depth: covers the 2(P−1)+1 window
        T = M + 2 * last
        for t in range(T):
            jf = t - s
            if 0 <= jf < M:
                y = stage.forward(jf, x_mb(jf) if s == 0 else act_in,
                                  "graph" if backward == "stored" else "input")
            else:
                y = zero
            dy = tail(t - last, y)
            jb = t - 2 * last + s
            if 0 <= jb < M:
                dx = back(stage, jb, dy if s == last else cot_in, jb == M - 1)
            else:
                dx = zero
            if t < T - 1:
                act_in, cot_in = neighbour_exchange(y, dx, axis, mesh)
    else:
        stage = _Stage(fn, params, M)  # every microbatch's graph, as autodiff keeps
        T = M + last
        dys = {}
        for t in range(T):
            jf = t - s
            y = stage.forward(jf, x_mb(jf) if s == 0 else act_in, "graph") if 0 <= jf < M else zero
            dy = tail(t - last, y)
            if dy is not None:
                dys[t - last] = dy
            if t < T - 1:
                act_in, _ = neighbour_exchange(y, None, axis, mesh)
        for t in reversed(range(T)):
            jb = t - s
            if 0 <= jb < M:
                dx = back(stage, jb, dys.pop(jb) if s == last else cot_in, jb == 0)
            else:
                dx = zero
            if t > 0:
                _, cot_in = neighbour_exchange(None, dx, axis, mesh)

    def mean_grad(leaf):
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        return leaf.grad.div_(M)

    loss = tail.total if sharded_loss else psum(tail.total, axis, mesh)
    d_loss = None
    if loss_params is not None:
        if sharded_loss:
            d_loss = _map(mean_grad, loss_params)
        else:
            d_loss = _map(lambda leaf: psum(leaf.grad if leaf.grad is not None else torch.zeros_like(leaf),
                                            axis, mesh) / M, loss_params)
    dx = torch.cat(dxs) / M if s == 0 else None
    return loss / M, (_map(mean_grad, stage_params), d_loss, dx)
