"""Ring attention over ``sp`` in the port (``parallel/ring.py``) against
the JAX package's ``ring_self_attention`` on an ``sp=4`` mesh of virtual
CPU devices, from the same numpy inputs (``tests/test_ring.py``'s shapes:
B 2, S 32, K 2, G 2, D 8).

The port runs in a four-rank gloo world (``tests/torch_worlds.py``): each
rank its block of 8 positions, so the ring passes fully masked, fully
visible and diagonal blocks. Tolerances are ``tests/test_ring.py``'s:
outputs within atol 2e-5, the gradients of q, k and v of ``mean(out²)``
within atol 5e-5. The planted fault, masking by each rank's local positions,
reads far above them. Also: the global view (``ring_self_attention``) on the
same mesh, its fallback to the dense path when S % sp != 0, the differentiable
``all_to_all`` against its definition, and ``examples/llama-long-context-
torch.yaml`` under the supervisor.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from tests import torch_worlds

ATOL_OUT, ATOL_GRAD = 2e-5, 5e-5
SP = 4


def _qkv(B=2, S=32, K=2, G=2, D=8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, K, G, D)).astype(np.float32)
    k = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v = rng.normal(size=(B, S, K, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int64), (B, S)).copy()
    return dict(q=q, k=k, v=v, pos=pos)


def _jax_ring(inputs, causal):
    """JAX's ring attention on sp=4: the output and the gradients of q, k
    and v of mean(out²)."""
    import jax
    import jax.numpy as jnp

    from pytorch_operator_tpu.parallel import make_mesh, ring_self_attention

    mesh = make_mesh(f"sp={SP}", devices=jax.devices()[:SP])
    pos = jnp.asarray(inputs["pos"], jnp.int32)

    def f(q, k, v):
        return ring_self_attention(q, k, v, pos, mesh, causal=causal)

    args = [jnp.asarray(inputs[a]) for a in "qkv"]
    out = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(lambda *a: (f(*a).astype(jnp.float32) ** 2).mean(), argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


CASES = {
    "causal": dict(fn="ring", causal=True),
    "not_causal": dict(fn="ring", causal=False),
    "global": dict(fn="ring_global", causal=True),
    "fallback": dict(fn="ring_global", causal=True, S=30),
    "planted_local_positions": dict(fn="ring", causal=True, local_pos=True),
}


def _inputs(case):
    return _qkv(S=CASES[case].get("S", 32))


@pytest.fixture(scope="module")
def world():
    cases = [dict({k: v for k, v in c.items() if k != "S"}, **_inputs(name)) for name, c in CASES.items()]
    ranks = torch_worlds.run_world("attention", cases, n=SP)
    return {name: [r["cases"][i] for r in ranks] for i, name in enumerate(CASES)}, ranks


def _assemble(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


@pytest.mark.parametrize("case", ["causal", "not_causal"])
def test_ring_shard_matches_jax_ring_on_sp4(case, world):
    out, grads = _jax_ring(_inputs(case), CASES[case]["causal"])
    ranks = world[0][case]
    np.testing.assert_allclose(_assemble(ranks, "out"), out, atol=ATOL_OUT, rtol=0)
    for key, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_assemble(ranks, key), want, atol=ATOL_GRAD, rtol=0, err_msg=key)


def test_global_view_gathers_the_blocks(world):
    """``ring_self_attention`` on the whole arrays: every rank returns the
    whole output; each rank's gradient covers its own block of q, k and v
    (their sum over the ranks is JAX's)."""
    out, grads = _jax_ring(_inputs("global"), True)
    ranks = world[0]["global"]
    for r in ranks:
        np.testing.assert_allclose(r["out"], out, atol=ATOL_OUT, rtol=0)
    for key, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(sum(r[key] for r in ranks), want, atol=ATOL_GRAD, rtol=0, err_msg=key)


def test_ring_falls_back_when_seq_does_not_divide_sp(world):
    """S 30 over sp=4: the dense single-shard path on every rank, JAX's
    result and gradients."""
    out, grads = _jax_ring(_inputs("fallback"), True)
    for r in world[0]["fallback"]:
        np.testing.assert_allclose(r["out"], out, atol=ATOL_OUT, rtol=0)
        for key, want in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(r[key], want, atol=ATOL_GRAD, rtol=0, err_msg=key)


def test_planted_local_positions_read_above_the_limit(world):
    """Masking by each rank's local positions lets rank 0 see later blocks
    and hides earlier ones from the others: far outside the tolerance."""
    out, _ = _jax_ring(_inputs("causal"), True)
    gap = np.abs(_assemble(world[0]["planted_local_positions"], "out") - out).max()
    assert gap > 100 * ATOL_OUT, gap


def test_all_to_all_is_jax_tiled_all_to_all(world):
    """``all_to_all(x, "sp", 1, 2)``: rank r receives block r of dim 1 from
    every rank j, concatenated along dim 2 in rank order."""
    n = SP
    xs = [np.arange(2.0 * n * 3 * n).reshape(2, n * 3, n) + 100 * j for j in range(n)]
    for r, got in enumerate(rk["all_to_all"] for rk in world[1]):
        want = np.concatenate([x[:, r * 3:(r + 1) * 3] for x in xs], axis=2)
        np.testing.assert_array_equal(got, want)


def test_example_long_context_runs_under_the_supervisor(tmp_path):
    """``examples/llama-long-context-torch.yaml`` as written: Master + 3
    Workers at sp=4 with ring attention train to success; the Master's
    result shows four sp coordinates of one data coordinate."""
    from pytorch_operator_tpu.api import load_job
    from pytorch_operator_tpu.controller import Supervisor

    job = load_job(Path(__file__).resolve().parents[1] / "examples" / "llama-long-context-torch.yaml")
    job.spec.port = None
    sup = Supervisor(state_dir=tmp_path / "state", poll_interval=0.1)
    try:
        done = sup.run(job, timeout=240)
    finally:
        sup.shutdown()
    log = (tmp_path / "state" / "logs" / "default_llama-long-context-torch-master-0.log").read_text()
    assert done.is_succeeded(), log[-3000:]
    result = json.loads(log.strip().splitlines()[-1])
    assert result["mesh"] == {"sp": 4} and result["world"] == 4 and result["backend"] == "gloo"
    assert [(r["data_index"], r["sp_index"]) for r in result["per_rank"]] == [(0, i) for i in range(4)]
    assert len(result["losses"]) == 12 and all(np.isfinite(result["losses"]))
