"""Ring-vs-ulysses communication cost of the port, counted by
``ops/flop_count.count_collectives`` (meta tensors, no process group: a
32k-sequence program costs nothing to count), against the JAX package's
counts on the same train-step-shaped call (``tests/test_sp_cost.py``'s
``_profile``: attention forward and backward through the gradient).

The port counts one device's program: its block of the sequence through
``ring_attention_shard`` / ``ulysses_attention_shard`` at coordinate 0 of
``sp``, the body JAX's ``shard_map`` runs on a device.

- ring: JAX makes 5P ppermutes per attention (3P forward rotations of k, v
  and the positions, 2P backward rotations of the k and v cotangents). The
  port leaves out JAX's last rotation, whose result is never read, and its
  two cotangent rotations: exactly 5(P-1), and exactly (P-1)/P of JAX's
  bytes (every rotation moves the same block).
- ulysses: exactly JAX's 8 all_to_alls and bytes, whatever P and S.
- ulysses under tp (``sp=2,tp=2``): with 2 kv heads (one a tp rank) the
  port gathers q, k and v over tp (3 all_gathers of this rank's blocks; the
  gradient keeps the rank's own block, no collective) and then makes JAX's
  8 all_to_alls with JAX's bytes on the global heads (JAX's ulysses is
  manual over sp only); with 4 kv heads (two a tp rank) it gathers nothing
  and makes the 8 all_to_alls on its own heads.

Gloo worlds of two and four ranks show that the counting mode's calls and
bytes equal the collectives a real run issues.
"""

import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu_torch.ops.flop_count import count_collectives
from pytorch_operator_tpu_torch.parallel.ring import ring_attention_shard
from pytorch_operator_tpu_torch.parallel.ulysses import ulysses_attention_shard, ulysses_attention_tp
from tests.test_sp_cost import B, D, G, K, _profile
from tests.torch_worlds import run_world


def _port(scheme: str, sp: int, S: int):
    blk = S // sp

    def leaf(*shape):
        return torch.empty(*shape, dtype=torch.bfloat16, device="meta", requires_grad=True)

    def f(q, k, v):
        if scheme == "ring":
            pos = torch.empty(B, blk, dtype=torch.int32, device="meta")
            out = ring_attention_shard(q, k, v, pos, pos, axis_name="sp")
        else:
            pos = torch.empty(B, S, dtype=torch.int32, device="meta")
            out = ulysses_attention_shard(q, k, v, pos, axis_name="sp")
        out.float().sum().backward()

    return count_collectives(f, leaf(B, blk, K, G, D), leaf(B, blk, K, D), leaf(B, blk, K, D),
                             axes={"sp": sp})


@pytest.mark.parametrize("sp", [4, 8])
@pytest.mark.parametrize("S", [4096, 32768])
def test_ring_is_5p_minus_5_ppermutes(sp, S):
    c, ref = _port("ring", sp, S), _profile("ring", sp, S)
    assert set(c.calls) == set(ref.calls) == {"ppermute"}, c.calls
    assert c.calls["ppermute"] == 5 * (sp - 1)
    assert round(ref.calls["ppermute"]) == 5 * sp
    # The unread rotation's share of JAX's bytes, exactly.
    assert c.total_bytes * sp == ref.total_bytes * (sp - 1)


@pytest.mark.parametrize("sp", [4, 8])
@pytest.mark.parametrize("S", [4096, 32768])
def test_ulysses_is_8_all_to_alls_as_jax(sp, S):
    c, ref = _port("ulysses", sp, S), _profile("ulysses", sp, S)
    assert c.calls == ref.calls == {"all_to_all": 8.0}
    assert c.bytes == ref.bytes


def test_bytes_shrink_with_p_for_ulysses_not_for_the_ring_block():
    u4, u8 = _port("ulysses", 4, 4096), _port("ulysses", 8, 4096)
    r4, r8 = _port("ring", 4, 4096), _port("ring", 8, 4096)
    assert u8.total_bytes == u4.total_bytes / 2
    # A rotation moves a block of S/P; (P-1) of them per pass: the whole
    # sequence but one block, nearly P-independent.
    assert r4.total_bytes / 3 == 2 * (r8.total_bytes / 7)
    for scheme in ("ring", "ulysses"):
        assert _port(scheme, 4, 32768).total_bytes == 8 * _port(scheme, 4, 4096).total_bytes


def test_counting_mode_equals_a_real_two_rank_run():
    cases = [("ring", 64), ("ulysses", 64)]
    for rank, results in enumerate(run_world("sp_cost", cases, n=2)):
        for (scheme, _), r in zip(cases, results):
            name = "ppermute" if scheme == "ring" else "all_to_all"
            calls, sent = r["real"][name]
            assert set(r["real"]) == set(r["calls"]) == {name}, (rank, scheme, r)
            assert (calls, sent) == (r["calls"][name], r["bytes"][name]), (rank, scheme, r)
            assert calls == (5 if scheme == "ring" else 8)
            assert r["grad_finite"]


def _jax_ulysses(sp: int, S: int, kv_heads: int):
    """JAX's count of ulysses on the global heads (``_profile``'s shapes
    with ``kv_heads``)."""
    import jax
    import jax.numpy as jnp

    from pytorch_operator_tpu.ops.flop_count import count_collectives as jax_count
    from pytorch_operator_tpu.parallel import make_mesh
    from pytorch_operator_tpu.parallel.ulysses import ulysses_self_attention

    mesh = make_mesh(f"sp={sp}", devices=jax.devices()[:sp])
    q = jnp.zeros((B, S, kv_heads, G, D), jnp.bfloat16)
    k = v = jnp.zeros((B, S, kv_heads, D), jnp.bfloat16)
    pos = jnp.zeros((B, S), jnp.int32)

    def f(q, k, v):
        return ulysses_self_attention(q, k, v, pos, mesh).astype(jnp.float32).sum()

    return jax_count(jax.grad(f, argnums=(0, 1, 2)), q, k, v)


def _port_tp(S: int, kv_heads: int):
    """The port's count of ``ulysses_attention_tp`` at coordinate 0 of
    ``sp=2,tp=2``: this rank's block of S and its ``kv_heads/2``."""
    blk, kh = S // 2, kv_heads // 2

    def leaf(*shape):
        return torch.empty(*shape, dtype=torch.bfloat16, device="meta", requires_grad=True)

    def f(q, k, v):
        pos = torch.empty(B, S, dtype=torch.int32, device="meta")
        ulysses_attention_tp(q, k, v, pos).float().sum().backward()

    return count_collectives(f, leaf(B, blk, kh, G, D), leaf(B, blk, kh, D), leaf(B, blk, kh, D),
                             axes={"sp": 2, "tp": 2})


@pytest.mark.parametrize("S", [4096, 32768])
def test_ulysses_under_tp_is_jax_8_all_to_alls_and_3_tp_gathers(S):
    """2 kv heads at tp=2: the gathers of q, k and v (this rank's blocks'
    bytes), then JAX's all_to_alls on the global heads."""
    c, ref = _port_tp(S, 2), _jax_ulysses(2, S, 2)
    assert ref.calls == {"all_to_all": 8.0}
    assert c.calls == {"all_to_all": 8.0, "all_gather": 3.0}
    assert c.bytes["all_to_all"] == ref.bytes["all_to_all"]
    blk = S // 2
    assert c.bytes["all_gather"] == 2 * (B * blk * G * D + 2 * B * blk * D)  # bf16 q, k, v of one head


def test_no_tp_gather_where_a_tp_ranks_kv_heads_split_over_sp():
    """4 kv heads at tp=2 (two a rank): the rank's own heads swapped, the 8
    all_to_alls of sp=2 on 2 heads, no gather."""
    c = _port_tp(4096, 4)
    assert c.calls == {"all_to_all": 8.0}
    assert c.bytes == _jax_ulysses(2, 4096, 2).bytes


def test_counting_mode_equals_a_real_four_rank_run_under_tp():
    cases = [("ulysses_tp", 64, 2), ("ulysses_tp", 64, 4)]
    for rank, results in enumerate(run_world("sp_cost", cases, n=4)):
        for (_, _, kv_heads), r in zip(cases, results):
            want = {"all_to_all": 8, "all_gather": 3} if kv_heads == 2 else {"all_to_all": 8}
            assert set(r["real"]) == set(r["calls"]) == set(want), (rank, kv_heads, r)
            for name, calls in want.items():
                assert r["real"][name] == (r["calls"][name], r["bytes"][name]), (rank, kv_heads, name, r)
                assert r["real"][name][0] == calls
            assert r["grad_finite"]
