"""Ring attention over the ``sp`` mesh axis — the port of
``pytorch_operator_tpu/parallel/ring.py``.

Sequence parallelism: each rank holds its block of the sequence, keeps its
queries, and passes K/V (with their positions) around the ring of the sp
ranks, accumulating attention as a streaming (online) softmax. A rank's
scores are ``[B, K, G, S/sp, S/sp]`` at a time, never ``[.., S, S]``.

Layout as in ``models/llama.py``'s grouped-query attention: q ``[B, S, K, G,
D]`` (K kv heads × G query groups), k/v ``[B, S, K, D]``, positions ``[B,
S]`` global token positions. The causal mask compares global positions
(``kv_pos <= q_pos``), so a block needs no index arithmetic whichever rank it
came from.

- :func:`ring_attention_shard`: the body a rank runs on its block (the
  model's sp path); the rotation is ``collectives.ring_shift``, whose
  gradient goes back around the ring.
- :func:`ring_self_attention`: the reference's global view: q/k/v and the
  positions whole on every rank; each rank runs its block and the blocks are
  gathered. With no sp axis (or of size 1), or a sequence that sp does not
  divide, it runs :func:`_single_shard`, as the reference does.
- :func:`_single_shard`: dense f32 attention, the oracle (and ulysses' body).

The reference's block is an XLA einsum, not a Pallas kernel; so is this one
(f32 ``einsum``s). Each block runs under ``torch.utils.checkpoint``, the
counterpart of the reference's ``jax.checkpoint``: its scores are recomputed
in the backward, never saved, so what the backward keeps is the carry and
the rotated K/V blocks, linear in S. The reference's last rotation, whose
result is never read, is left out.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .collectives import all_gather_autograd, axis_index, axis_size, ring_shift


def _block(m, l, o, q32, k_blk, v_blk, q_pos, kv_pos, causal: bool):
    """One K/V block folded into the online-softmax carry ``(m, l, o)``
    (``[B,K,G,Sq]``, ``[B,K,G,Sq]``, ``[B,K,G,Sq,D]``, all f32)."""
    s = torch.einsum("bskgd,btkd->bkgst", q32, k_blk.float())
    if causal:
        ok = kv_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
        s = s.masked_fill(~ok, torch.finfo(torch.float32).min)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, v_blk.float())
    return m_new, l, o


def ring_attention_shard(
    q, k, v, q_positions, kv_positions, *, axis_name: str = "sp", mesh=None, causal: bool = True,
):
    """Streaming attention over K/V blocks rotated around ``axis_name`` of
    ``mesh`` (None: the whole world). This rank's q ``[B,Sq,K,G,D]``, k/v
    ``[B,Skv,K,D]``, q_positions ``[B,Sq]``, kv_positions ``[B,Skv]``;
    returns ``[B,Sq,K,G,D]`` in q's dtype.

    f32 accumulators: running max ``m``, denominator ``l``, numerator ``o``;
    each block rescales them by ``exp(m - m_new)``. q is scaled by
    ``1/sqrt(D)`` before the product, as in the reference. A masked score is
    ``finfo(f32).min``, so a fully masked block adds exactly zero; under the
    causal mask every query sees its own diagonal in the first (local)
    block, so ``m`` is finite from the first step."""
    B, Sq, K, G, D = q.shape
    n = axis_size(axis_name, mesh)
    neg = torch.finfo(torch.float32).min
    q32 = q.float() * (1.0 / math.sqrt(D))
    m = torch.full((B, K, G, Sq), neg, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, K, G, Sq, D), dtype=torch.float32, device=q.device)
    k_cur, v_cur, pos_cur = k, v, kv_positions
    for step in range(n):
        if torch.is_grad_enabled():
            m, l, o = checkpoint(_block, m, l, o, q32, k_cur, v_cur, q_positions, pos_cur, causal,
                                 use_reentrant=False)
        else:
            m, l, o = _block(m, l, o, q32, k_cur, v_cur, q_positions, pos_cur, causal)
        if step < n - 1:
            # One hop around the ring, in the blocks' own dtype.
            k_cur = ring_shift(k_cur, axis_name, mesh)
            v_cur = ring_shift(v_cur, axis_name, mesh)
            pos_cur = ring_shift(pos_cur, axis_name, mesh)
    # [B,K,G,Sq,D] -> [B,Sq,K,G,D]; l > 0 everywhere.
    out = o / l[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _sp_size(mesh, axis_name: str) -> int:
    if mesh is None:
        return 1
    from .mesh import axis_sizes

    return axis_sizes(mesh).get(axis_name, 1)


def ring_self_attention(q, k, v, positions, mesh, *, axis_name: str = "sp", causal: bool = True):
    """The global view: q ``[B,S,K,G,D]``, k/v ``[B,S,K,D]``, positions
    ``[B,S]`` whole and the same on every rank of ``axis_name``; returns the
    whole ``[B,S,K,G,D]``. Each rank runs :func:`ring_attention_shard` on its
    block of S and the blocks are gathered. No ``axis_name`` on ``mesh`` (or
    ``mesh=None``, a world of one process), an axis of size 1, or S % sp ≠ 0
    run :func:`_single_shard`."""
    n = _sp_size(mesh, axis_name)
    S = q.shape[1]
    if n == 1 or S % n:
        return _single_shard(q, k, v, positions, causal=causal)
    i, blk = axis_index(axis_name, mesh), S // n
    mine = slice(i * blk, (i + 1) * blk)
    out = ring_attention_shard(
        q[:, mine], k[:, mine], v[:, mine], positions[:, mine], positions[:, mine],
        axis_name=axis_name, mesh=mesh, causal=causal,
    )
    return all_gather_autograd(out, axis_name, mesh, dim=1)


def _single_shard(q, k, v, positions, *, causal: bool):
    """Dense attention on one rank in f32 (the scores divided by ``sqrt(D)``
    after the product, as in the reference): the oracle of the ring, the
    fallback of both sp schemes, and ulysses' body."""
    D = q.shape[-1]
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) / math.sqrt(D)
    if causal:
        ok = positions[:, None, None, None, :] <= positions[:, None, None, :, None]
        s = s.masked_fill(~ok, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.float()).to(q.dtype)
