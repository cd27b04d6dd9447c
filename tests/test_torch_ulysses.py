"""Ulysses attention over ``sp`` in the port (``parallel/ulysses.py``)
against the JAX package's ``ulysses_self_attention`` on an ``sp=2`` mesh of
virtual CPU devices, from the same numpy inputs (``tests/test_ulysses.py``'s
shapes: B 2, S 32, K 2, G 2, D 8).

The port runs in a two-rank gloo world (``tests/torch_worlds.py``): each
rank its block of 16 positions, swapped by the differentiable all-to-all to
one kv head of all 32 positions. Tolerances are ``tests/test_ulysses.py``'s:
outputs within atol 2e-5, the gradients of q, k and v of ``mean(out²)``
within atol 5e-5. Also the global view and its fallback when S % sp != 0,
and the reference's refusal of a kv-head count sp does not divide (the same
message).

Under tp, in a four-rank ``sp=2,tp=2`` world: each rank holds its sp block
of the sequence and its tp block of the heads. With 2 kv heads (one a tp
rank, which sp=2 cannot split) ``ulysses_attention_tp`` gathers the global
heads over tp and keeps its own of the output; with 4 (two a tp rank) it
swaps its own and gathers nothing. Both against JAX's
``ulysses_self_attention`` on the global tensors of an ``sp=2,tp=2`` mesh,
at the same tolerances; the planted fault that keeps the heads at the sp
coordinate instead of the tp coordinate reads far outside them.
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.parallel import ulysses
from pytorch_operator_tpu_torch.parallel.sharding import SequenceParallel, TensorParallel
from tests import torch_worlds
from tests.test_torch_ring import _qkv

ATOL_OUT, ATOL_GRAD = 2e-5, 5e-5
SP = 2


def _jax_ulysses(inputs, causal, spec=f"sp={SP}"):
    import jax
    import jax.numpy as jnp

    from pytorch_operator_tpu.parallel import make_mesh
    from pytorch_operator_tpu.parallel.ulysses import ulysses_self_attention

    n = int(np.prod([int(a.split("=")[1]) for a in spec.split(",")]))
    mesh = make_mesh(spec, devices=jax.devices()[:n])
    pos = jnp.asarray(inputs["pos"], jnp.int32)

    def f(q, k, v):
        return ulysses_self_attention(q, k, v, pos, mesh, causal=causal)

    args = [jnp.asarray(inputs[a]) for a in "qkv"]
    out = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(lambda *a: (f(*a).astype(jnp.float32) ** 2).mean(), argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


CASES = {
    "causal": dict(fn="ulysses", causal=True),
    "not_causal": dict(fn="ulysses", causal=False),
    "global": dict(fn="ulysses_global", causal=True),
    "fallback": dict(fn="ulysses_global", causal=True, S=31),
}


def _inputs(case):
    return _qkv(S=CASES[case].get("S", 32))


@pytest.fixture(scope="module")
def world():
    cases = [dict({k: v for k, v in c.items() if k != "S"}, **_inputs(name)) for name, c in CASES.items()]
    ranks = torch_worlds.run_world("attention", cases, n=SP)
    return {name: [r["cases"][i] for r in ranks] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("case", ["causal", "not_causal"])
def test_ulysses_shard_matches_jax_on_sp2(case, world):
    out, grads = _jax_ulysses(_inputs(case), CASES[case]["causal"])
    ranks = world[case]
    np.testing.assert_allclose(np.concatenate([r["out"] for r in ranks], 1), out, atol=ATOL_OUT, rtol=0)
    for key, want in zip(("dq", "dk", "dv"), grads):
        got = np.concatenate([r[key] for r in ranks], 1)
        np.testing.assert_allclose(got, want, atol=ATOL_GRAD, rtol=0, err_msg=key)


@pytest.mark.parametrize("case", ["global", "fallback"])
def test_global_view_and_its_fallback(case, world):
    """The whole output on every rank; the ranks' gradients add up to
    JAX's (the fallback, S 31 over sp=2, runs the dense path whole on each
    rank: each rank's gradient is JAX's)."""
    out, grads = _jax_ulysses(_inputs(case), True)
    ranks = world[case]
    for r in ranks:
        np.testing.assert_allclose(r["out"], out, atol=ATOL_OUT, rtol=0)
    for key, want in zip(("dq", "dk", "dv"), grads):
        got = sum(r[key] for r in ranks) if case == "global" else ranks[1][key]
        np.testing.assert_allclose(got, want, atol=ATOL_GRAD, rtol=0, err_msg=key)


def test_kv_heads_sp_does_not_divide_raise_jax_error():
    import jax
    import jax.numpy as jnp

    from pytorch_operator_tpu.parallel import make_mesh
    from pytorch_operator_tpu.parallel.ulysses import ulysses_self_attention

    x = _qkv(K=3)
    mesh = make_mesh(f"sp={SP}", devices=jax.devices()[:SP])
    with pytest.raises(ValueError) as want:
        ulysses_self_attention(*(jnp.asarray(x[a]) for a in "qkv"), jnp.asarray(x["pos"]), mesh)
    with pytest.raises(ValueError) as got:
        ulysses.check_kv_heads(3, SP)
    assert str(got.value) == str(want.value)
    cfg = port_llama.llama_tiny(attn_impl="ulysses", n_heads=3, n_kv_heads=3, head_dim=16)
    with pytest.raises(ValueError, match="n_kv_heads % sp == 0"):
        port_llama.Attention(cfg, sp=SequenceParallel(SP, 0))
    # 2 kv heads: sp=2 alone splits them; under tp=2 (one a tp rank) the
    # layer builds too, and swaps the global heads.
    cfg = port_llama.llama_tiny(attn_impl="ulysses")
    assert port_llama.Attention(cfg, sp=SequenceParallel(SP, 0)).n_kv_heads == 2
    assert port_llama.Attention(cfg, tp=TensorParallel(2, 0), sp=SequenceParallel(SP, 0)).n_kv_heads == 1


TP_CASES = {
    "gathered": dict(K=2),
    "own_heads": dict(K=4),
    "gathered_planted": dict(K=2, plant="ulysses_sp_heads"),
}


@pytest.fixture(scope="module")
def tp_world():
    cases = [dict(_qkv(K=c["K"]), causal=True, plant=c.get("plant")) for c in TP_CASES.values()]
    ranks = torch_worlds.run_world("ulysses_tp", cases, n=4)
    return {name: [r[i] for r in ranks] for i, name in enumerate(TP_CASES)}


def _assemble(ranks, key, like):
    """The global array from the ranks' (sequence block, head block)s."""
    whole = np.full(like.shape, np.nan, np.float32)
    for r in ranks:
        whole[:, slice(*r["rows"]), slice(*r["heads"])] = r[key]
    return whole


def _tp_gaps(case, tp_world) -> dict:
    K = TP_CASES[case]["K"]
    out, grads = _jax_ulysses(_qkv(K=K), True, spec="sp=2,tp=2")
    ranks = tp_world[case]
    gaps = {"out": float(np.abs(_assemble(ranks, "out", out) - out).max())}
    for key, want in zip(("dq", "dk", "dv"), grads):
        gaps[key] = float(np.abs(_assemble(ranks, key, want) - want).max())
    return gaps


@pytest.mark.parametrize("case", ["gathered", "own_heads"])
def test_ulysses_under_tp_matches_jax_on_the_global_heads(case, tp_world):
    """Output and gradients against JAX's on sp=2,tp=2; the tp gathers of
    q, k and v only where a tp rank's kv heads do not split over sp."""
    gaps = _tp_gaps(case, tp_world)
    assert gaps["out"] <= ATOL_OUT, gaps
    assert max(gaps[k] for k in ("dq", "dk", "dv")) <= ATOL_GRAD, gaps
    want = 3 if TP_CASES[case]["K"] // 2 % SP else 0
    assert [r["tp_gathers"] for r in tp_world[case]] == [want] * 4


def test_planted_sp_coordinate_heads_break_the_output(tp_world):
    """Keeping the global output's heads at the sp coordinate: the ranks
    whose sp and tp coordinates differ hold another head's output."""
    gaps = _tp_gaps("gathered_planted", tp_world)
    print(f"ulysses sp-coordinate heads fault: {gaps}")
    assert gaps["out"] > 10 * ATOL_OUT and gaps["dq"] > 10 * ATOL_GRAD, gaps
