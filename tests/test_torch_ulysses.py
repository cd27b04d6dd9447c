"""Ulysses attention over ``sp`` in the port (``parallel/ulysses.py``)
against the JAX package's ``ulysses_self_attention`` on an ``sp=2`` mesh of
virtual CPU devices, from the same numpy inputs (``tests/test_ulysses.py``'s
shapes: B 2, S 32, K 2, G 2, D 8).

The port runs in a two-rank gloo world (``tests/torch_worlds.py``): each
rank its block of 16 positions, swapped by the differentiable all-to-all to
one kv head of all 32 positions. Tolerances are ``tests/test_ulysses.py``'s:
outputs within atol 2e-5, the gradients of q, k and v of ``mean(out²)``
within atol 5e-5. Also the global view and its fallback when S % sp != 0,
the reference's refusal of a kv-head count sp does not divide (the same
message), and the port's own refusal, by name, of a tp rank's kv heads that
sp does not divide.
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


def _jax_ulysses(inputs, causal):
    import jax
    import jax.numpy as jnp

    from pytorch_operator_tpu.parallel import make_mesh
    from pytorch_operator_tpu.parallel.ulysses import ulysses_self_attention

    mesh = make_mesh(f"sp={SP}", devices=jax.devices()[:SP])
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


def test_a_tp_ranks_kv_heads_sp_does_not_divide_are_refused_by_name():
    """2 kv heads over tp=2 leave one a tp rank: the port's ulysses swaps a
    tp rank's own heads, so sp=2 is refused naming ROADMAP.md item 3c-2d
    (JAX swaps the global heads and runs it); sp=2 alone runs."""
    cfg = port_llama.llama_tiny(attn_impl="ulysses")
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 3c-2d"):
        port_llama.Attention(cfg, tp=TensorParallel(2, 0), sp=SequenceParallel(SP, 0))
    assert port_llama.Attention(cfg, sp=SequenceParallel(SP, 0)).n_kv_heads == 2
