"""Ulysses sequence parallelism over ``sp`` — the port of
``pytorch_operator_tpu/parallel/ulysses.py``.

The other sp scheme beside the ring (``ring.py``): one all-to-all re-shards
q, k and v from sequence-sharded to kv-head-sharded, attention runs over the
whole sequence for ``1/sp`` of the kv heads a rank (``ring._single_shard``,
the same oracle as the ring's), and one all-to-all swaps back. The heads are
the resharding currency: ``n_kv_heads % sp`` must be 0.

Layout as in ``models/llama.py``: q ``[B,S,K,G,D]``, k/v ``[B,S,K,D]``,
positions ``[B,S]``. The swaps are ``collectives.all_to_all`` (gloo and NCCL
carry ``all_to_all_single`` on CUDA tensors), differentiated by the inverse
swap.
"""

from __future__ import annotations

from .collectives import all_to_all, axis_index
from .ring import _GatherSeq, _single_shard, _sp_size


def ulysses_attention_shard(q, k, v, positions_full, *, axis_name: str = "sp", mesh=None,
                            causal: bool = True):
    """The body a rank runs: q ``[B,S/P,K,G,D]`` and k/v ``[B,S/P,K,D]``, its
    block of the sequence; ``positions_full`` ``[B,S]``, the global positions
    (the mask needs the whole row). Returns ``[B,S/P,K,G,D]``."""
    # Sequence-sharded -> head-sharded: the kv heads split P ways, the
    # sequence gathered.
    qh = all_to_all(q, axis_name, 2, 1, mesh)
    kh = all_to_all(k, axis_name, 2, 1, mesh)
    vh = all_to_all(v, axis_name, 2, 1, mesh)
    out = _single_shard(qh, kh, vh, positions_full, causal=causal)
    # Head-sharded -> sequence-sharded (the inverse swap).
    return all_to_all(out, axis_name, 1, 2, mesh)


def check_kv_heads(n_kv_heads: int, sp: int, axis_name: str = "sp") -> None:
    """The reference's refusal of a kv-head count that ``sp`` does not
    divide (a static configuration error: running dense full-S attention
    instead would lose what ulysses is for while sp looks active)."""
    if sp > 1 and n_kv_heads % sp:
        raise ValueError(
            f"attn_impl='ulysses' needs n_kv_heads % {axis_name} == 0 "
            f"(kv heads are the resharding currency): got "
            f"{n_kv_heads} kv heads, {axis_name}={sp}. Use a config with "
            f"divisible kv heads, a smaller {axis_name}, or attn_impl='ring'."
        )


def ulysses_self_attention(q, k, v, positions, mesh, *, axis_name: str = "sp", causal: bool = True):
    """The global view, as :func:`ring.ring_self_attention`'s: q/k/v and the
    positions whole on every rank of ``axis_name``, the whole output
    returned. A kv-head count that sp does not divide raises ValueError; no
    sp axis (or ``mesh=None``), an axis of size 1, or S % sp ≠ 0 run the
    single-shard path."""
    n = _sp_size(mesh, axis_name)
    check_kv_heads(q.shape[2], n, axis_name)
    S = q.shape[1]
    if n == 1 or S % n:
        return _single_shard(q, k, v, positions, causal=causal)
    i, blk = axis_index(axis_name, mesh), S // n
    mine = slice(i * blk, (i + 1) * blk)
    out = ulysses_attention_shard(q[:, mine], k[:, mine], v[:, mine], positions,
                                  axis_name=axis_name, mesh=mesh, causal=causal)
    return _GatherSeq.apply(out, axis_name, mesh)
