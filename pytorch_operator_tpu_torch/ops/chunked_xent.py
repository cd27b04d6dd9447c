"""Memory-efficient softmax cross-entropy for large-vocab LM heads.

The counterpart of ``pytorch_operator_tpu/ops/chunked_xent.py``: the LM-head
matmul fused with the loss. A loop over vocab chunks keeps only ``[N,
chunk]`` logits alive, carrying an online logsumexp (running max and scaled
sum) across chunks, and the backward recomputes each chunk's logits instead of
saving them. No ``[N, V]`` logits tensor ever exists.

The JAX package leaves this to XLA (a ``lax.scan`` of plain matmuls, no
Pallas kernel), so the port is plain PyTorch: each chunk's products go to
``torch.matmul``. Semantics kept from the JAX op:

- logits math is f32 whatever the input dtype;
- labels clamp to ``[0, V)``;
- a vocab that does not divide into chunks takes a clamped tail chunk
  (``start = min(c·chunk, V − chunk)``) whose already-counted columns are
  masked out (:func:`_fresh_mask`), with no padding copy;
- the label correction in the backward is an indexed add into the chunk's
  gradient, not a one-hot.

The vocab-parallel loss of a tensor-parallel model (the head split over
``tp`` by vocabulary), and of a pipeline's tail (split over ``pp``), is
built on :func:`chunked_vocab_stats`, the JAX
op's combinable form: each rank takes its head columns' online-softmax
stats ``(m, s, lab_logit)`` chunk by chunk, and one pmax and two psums over
tp combine them (:func:`vocab_parallel_xent`). Its backward recomputes each
local chunk's logits against the global logsumexp; no ``[N, V]`` tensor and
no gathered head is built.
"""

from __future__ import annotations

import math

import torch

from ..parallel.collectives import pmax, psum


def _fresh_mask(start: int, c_idx: int, chunk: int, device) -> torch.Tensor:
    """True for the columns of chunk ``c_idx`` (read from ``start``) that no
    earlier chunk counted."""
    return start + torch.arange(chunk, device=device) >= c_idx * chunk


def _chunks(V: int, chunk: int):
    """``(c_idx, start)`` of every chunk; the tail chunk's start is clamped
    so that it reads ``chunk`` columns inside ``[0, V)``."""
    return [(c, min(c * chunk, V - chunk)) for c in range(-(-V // chunk))]


class ChunkedSoftmaxXent(torch.autograd.Function):
    """``apply(hidden [N,D], w [D,V], labels [N] int64 in [0,V), chunk)`` →
    per-token ``-log p(label)`` f32 ``[N]``; gradients to hidden and w."""

    @staticmethod
    def forward(ctx, hidden, w, labels, chunk):
        N = hidden.shape[0]
        V = w.shape[1]
        h32 = hidden.float()
        m = torch.full((N,), float("-inf"), device=hidden.device)
        s = torch.zeros(N, device=hidden.device)
        lab_logit = torch.zeros(N, device=hidden.device)
        for c_idx, start in _chunks(V, chunk):
            logits = h32 @ w[:, start : start + chunk].float()  # [N, chunk] f32
            fresh = _fresh_mask(start, c_idx, chunk, hidden.device)
            logits = logits.masked_fill(~fresh[None, :], float("-inf"))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = labels - start
            in_chunk = (labels >= c_idx * chunk) & (local < chunk)
            picked = logits.gather(1, local.clamp(0, chunk - 1)[:, None])[:, 0]
            lab_logit = torch.where(in_chunk, picked, lab_logit)
        lse = m + torch.log(s)
        ctx.save_for_backward(hidden, w, labels, lse)
        ctx.chunk = chunk
        return lse - lab_logit

    @staticmethod
    def backward(ctx, ct):
        hidden, w, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        N = hidden.shape[0]
        h32 = hidden.float()
        ct32 = ct.float()
        dh = torch.zeros(h32.shape, dtype=torch.float32, device=hidden.device)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        rows = torch.arange(N, device=hidden.device)
        for c_idx, start in _chunks(w.shape[1], chunk):
            w_c = w[:, start : start + chunk].float()
            g = torch.exp(h32 @ w_c - lse[:, None]) * ct32[:, None]  # softmax chunk · ct
            local = labels - start
            in_chunk = (labels >= c_idx * chunk) & (local < chunk)
            # The label correction as an indexed add (one entry a row), not
            # a second [N, chunk] one-hot buffer.
            g.index_put_(
                (rows, local.clamp(0, chunk - 1)), -ct32 * in_chunk, accumulate=True
            )
            # Tail chunk: zero the already-counted columns so the overlapped
            # read-add-write into dw cannot count them twice.
            g.mul_(_fresh_mask(start, c_idx, chunk, hidden.device)[None, :])
            dh.add_(g @ w_c.T)
            dw[:, start : start + chunk].add_(h32.T @ g)
        return dh.to(hidden.dtype), dw.to(w.dtype), None, None


def chunked_softmax_xent(hidden, w, labels, *, chunk: int = 8192):
    """Per-token ``-log p(label)`` without materializing ``[N, V]`` logits.

    hidden ``[N, D]`` (bf16/f32), w ``[D, V]`` (the LM-head kernel), labels
    ``[N]`` int. Returns float32 ``[N]``. Gradients flow to ``hidden`` and
    ``w``. Out-of-range labels clamp to ``[0, V)``, a defined behavior where
    the dense path yields NaN.
    """
    N, D = hidden.shape
    D2, V = w.shape
    if D != D2:
        raise ValueError(f"hidden D={D} vs w D={D2}")
    labels = labels.long().clamp(0, V - 1)
    return ChunkedSoftmaxXent.apply(hidden, w, labels, min(chunk, V))


def chunked_vocab_stats(hidden, w, labels, *, chunk: int = 8192, col_offset: int = 0):
    """Online-softmax partial stats of ``hidden @ w`` for one (possibly
    vocab-sharded) block of head columns, the JAX op's: f32 ``[N]`` triples

    - ``m``: the largest logit over this block's columns;
    - ``s``: the sum of ``exp(logit - m)`` over them;
    - ``lab_logit``: the label's logit where the global label id lies in
      ``[col_offset, col_offset + w.shape[1])``, else 0.

    The owners of the blocks combine them with one pmax and two psums:
    ``M = pmax(m); lse = M + log(psum(s·exp(m − M))); loss = lse −
    psum(lab_logit)``. Differentiable as plain torch ops (the
    vocab-parallel loss calls it without autograd and has its own
    backward)."""
    N = hidden.shape[0]
    Vl = w.shape[1]
    c = min(chunk, Vl)
    h32 = hidden.float()
    labels = labels.long() - col_offset
    m = torch.full((N,), float("-inf"), device=hidden.device)
    s = torch.zeros(N, device=hidden.device)
    lab_logit = torch.zeros(N, device=hidden.device)
    for c_idx, start in _chunks(Vl, c):
        logits = h32 @ w[:, start : start + c].float()
        logits = logits.masked_fill(~_fresh_mask(start, c_idx, c, hidden.device)[None, :], float("-inf"))
        m_new = torch.maximum(m, logits.detach().amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        local = labels - start
        in_chunk = (labels >= c_idx * c) & (local < c) & (local >= 0)
        picked = logits.gather(1, local.clamp(0, c - 1)[:, None])[:, 0]
        lab_logit = torch.where(in_chunk, picked, lab_logit)
    return m, s, lab_logit


def _axes(tp) -> tuple:
    """``tp`` as a tuple of axes: one ``AxisParallel``, or several."""
    return tuple(tp) if isinstance(tp, (tuple, list)) else (tp,)


def combine_vocab_stats(m, s, lab_logit, tp):
    """The logsumexp and the per-token loss ``lse − lab_logit`` of the whole
    vocabulary from each rank's :func:`chunked_vocab_stats` over the axis of
    ``tp`` (``sharding.TensorParallel``, or pp's ``PipelineParallel``): one
    pmax, two psums; or over several axes (a sequence, innermost first: a
    pp stage's rows cut again by tp), each reduction over each in turn."""
    axes = _axes(tp)
    M = m
    for ax in axes:
        M = pmax(M, ax.axis, ax.mesh)
    total, lab = s * torch.exp(m - M), lab_logit
    for ax in axes:
        total = psum(total, ax.axis, ax.mesh)
    lse = M + torch.log(total)
    for ax in axes:
        lab = psum(lab, ax.axis, ax.mesh)
    return lse, lse - lab


class VocabParallelXent(torch.autograd.Function):
    """``apply(hidden [N,D], w [D,V/tp], labels [N] in [0,V), chunk,
    col_offset, tp)`` → per-token ``-log p(label)`` f32 ``[N]`` over the
    whole vocabulary; gradients to hidden (this rank's part: the caller's
    ``tp_enter`` sums them) and to this rank's head columns."""

    @staticmethod
    def forward(ctx, hidden, w, labels, chunk, col_offset, tp):
        m, s, lab_logit = chunked_vocab_stats(hidden, w, labels, chunk=chunk, col_offset=col_offset)
        lse, loss = combine_vocab_stats(m, s, lab_logit, tp)
        ctx.save_for_backward(hidden, w, labels, lse)
        ctx.chunk, ctx.col_offset = chunk, col_offset
        return loss

    @staticmethod
    def backward(ctx, ct):
        hidden, w, labels, lse = ctx.saved_tensors
        c = min(ctx.chunk, w.shape[1])
        N = hidden.shape[0]
        h32, ct32 = hidden.float(), ct.float()
        labels = labels - ctx.col_offset
        dh = torch.zeros(h32.shape, dtype=torch.float32, device=hidden.device)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        rows = torch.arange(N, device=hidden.device)
        for c_idx, start in _chunks(w.shape[1], c):
            w_c = w[:, start : start + c].float()
            g = torch.exp(h32 @ w_c - lse[:, None]) * ct32[:, None]
            local = labels - start
            in_chunk = (labels >= c_idx * c) & (local < c) & (local >= 0)
            g.index_put_((rows, local.clamp(0, c - 1)), -ct32 * in_chunk, accumulate=True)
            g.mul_(_fresh_mask(start, c_idx, c, hidden.device)[None, :])
            dh.add_(g @ w_c.T)
            dw[:, start : start + c].add_(h32.T @ g)
        return dh.to(hidden.dtype), dw.to(w.dtype), None, None, None, None


def vocab_parallel_xent(hidden, w, labels, *, tp, col_offset: int, chunk: int = 8192,
                        enter: bool = True):
    """Per-token ``-log p(label)`` f32 ``[N]`` of a head split over ``tp``
    (an ``AxisParallel``: tp's, or pp's on a pipeline's vocab-parallel tail;
    or a sequence of axes, innermost first, whose blocks nest) by
    vocabulary: ``w`` ``[D, V/tp]`` is this rank's block of columns,
    starting at id ``col_offset``; ``hidden`` ``[N, D]`` is the same on every
    rank of the axis. Equal to :func:`chunked_softmax_xent` on the whole
    head, in value and gradients (hidden's summed over the axis by
    ``tp_enter``, one axis only; with ``enter=False`` hidden's gradient is
    this rank's part, which the caller sums). Labels clamp to ``[0, V)`` as
    there."""
    V = w.shape[1] * math.prod(ax.size for ax in _axes(tp))
    if hidden.shape[1] != w.shape[0]:
        raise ValueError(f"hidden D={hidden.shape[1]} vs w D={w.shape[0]}")
    labels = labels.long().clamp(0, V - 1)
    return VocabParallelXent.apply(tp.enter(hidden) if enter else hidden, w, labels, chunk, col_offset, tp)
