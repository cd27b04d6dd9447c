"""Ulysses sequence parallelism over ``sp`` — the port of
``pytorch_operator_tpu/parallel/ulysses.py``.

The other sp scheme beside the ring (``ring.py``): one all-to-all re-shards
q, k and v from sequence-sharded to kv-head-sharded, attention runs over the
whole sequence for ``1/sp`` of the kv heads a rank (``ring._single_shard``,
the same oracle as the ring's), and one all-to-all swaps back. The heads are
the resharding currency: ``n_kv_heads % sp`` must be 0.

Under tensor parallelism a rank holds ``n_kv_heads/tp`` of the kv heads.
Where sp divides those, :func:`ulysses_attention_tp` swaps them as they
are. Where it does not (``llama_0_3b``'s 4 kv heads at tp=4, sp=2: one a
tp rank), it swaps the global heads, as the reference's ``shard_map``
(manual over sp only) does: q, k and v are gathered over tp along the head
dim, the swap and the attention run on all ``n_kv_heads``, and the rank
keeps its own heads of the output. Heads are independent, so this is the
reference's function; it costs each tp rank the attention of every head's
``1/sp`` (the tp ranks of one sp coordinate compute the same) and the
gather's bytes. The gather's gradient is the rank's own block of the
cotangent, with no sum over tp: the rank keeps only its own heads of the
output, so the other heads' cotangent is zero there.

Layout as in ``models/llama.py``: q ``[B,S,K,G,D]``, k/v ``[B,S,K,D]``,
positions ``[B,S]``. The swaps are ``collectives.all_to_all`` (gloo and NCCL
carry ``all_to_all_single`` on CUDA tensors), differentiated by the inverse
swap; the tp gather is ``collectives.all_gather_autograd``.
"""

from __future__ import annotations

from .collectives import all_gather_autograd, all_to_all, axis_index, axis_size
from .ring import _single_shard, _sp_size

# The tp gathers of q, k and v issued by :func:`ulysses_attention_tp` in
# this process (three a layer a forward, the recompute of a rematerialised
# block included), as the flash wrappers count their launches.
tp_gather_count = 0


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


def own_heads(out, n: int, axis: str, mesh):
    """This rank's ``n`` heads (dim 2) of ``out``, which holds every rank of
    ``axis``'s heads in rank order."""
    return out.narrow(2, axis_index(axis, mesh) * n, n)


def ulysses_attention_tp(q, k, v, positions_full, *, mesh=None, axis_name: str = "sp",
                         tp_axis: str = "tp", causal: bool = True):
    """:func:`ulysses_attention_shard` for a rank that holds its block of
    the heads over ``tp_axis`` (q ``[B,S/P,K/tp,G,D]``, k/v ``[B,S/P,K/tp,D]``;
    all of them without tp): its own heads swapped where ``axis_name``
    divides them, else the global heads gathered over ``tp_axis`` first and
    this rank's kept of the output (the module docstring). Returns
    ``[B,S/P,K/tp,G,D]``."""
    global tp_gather_count
    K = k.shape[2]
    if K % axis_size(axis_name, mesh) == 0:
        return ulysses_attention_shard(q, k, v, positions_full, axis_name=axis_name, mesh=mesh,
                                       causal=causal)
    q, k, v = (all_gather_autograd(t, tp_axis, mesh, dim=2) for t in (q, k, v))
    tp_gather_count += 3
    out = ulysses_attention_shard(q, k, v, positions_full, axis_name=axis_name, mesh=mesh,
                                  causal=causal)
    return own_heads(out, K, tp_axis, mesh)


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
    return all_gather_autograd(out, axis_name, mesh, dim=1)
