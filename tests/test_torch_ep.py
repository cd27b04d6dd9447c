"""Expert parallelism in the port: the MoE layer's mesh paths
(``parallel/moe.py``: ``moe_mlp(mesh)``, ``moe_mlp_sparse(mesh)``) and
``llama_train.run`` with ``--experts`` on meshes with ``ep``, against the
JAX package on the same meshes over virtual CPU devices.

The layer: an ``ep=2`` world (and ``ep=2,tp=2``, MoE under tp) against JAX's
``moe_mlp``/``moe_mlp_sparse`` on ``ep=2`` (``ep=2,tp=2``), from numpy inputs;
outputs within atol 1e-5 and the gradients of the router, of each rank's
block of the banks (held against JAX's rows of them) and of x within atol
1e-6 (``tests/test_torch_moe.py``'s ``ATOL_OUT, ATOL_GRAD``); dense at
top_k 1 and 2, sparse at ample and tight capacity.

Training (tiny config, 4 experts, seed 0's JAX init, AdamW, 1 + 2 steps):
``ep=2`` dense and sparse (aux 1e-2), ``tp=2`` (each rank every expert's
half of F), ``dp=2,ep=2`` dense and ``ep=2,tp=2`` dense; final parameters against JAX's ``llama_train.run`` on the same mesh
within atol 3e-5 (``tests/test_torch_dist_train.py``'s), every step's loss
against the port's one process within rtol 1e-5; each rank holds half the
expert bytes; the ``ep=2`` run's checkpoint restores in one process bit for
bit, and by four ranks at dp=2,ep=2, each reading only its own blocks.
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.workloads import llama_train
from tests import torch_worlds

ATOL_OUT, ATOL_GRAD = 1e-5, 1e-6
E, D, F, N = 4, 16, 32, 64
KW = dict(config="tiny", batch_size=8, seq_len=32, steps=2, warmup=1, lr=3e-4, n_experts=4)
TWO = {
    "ep_dense": dict(KW, mesh_spec="ep=2"),
    "ep_sparse": dict(KW, mesh_spec="ep=2", moe_dispatch="sparse", moe_aux_weight=1e-2),
    "tp_dense": dict(KW, mesh_spec="tp=2"),
}
FOUR = {
    "dp_ep_dense": dict(KW, mesh_spec="dp=2,ep=2"),
    "ep_tp_dense": dict(KW, mesh_spec="ep=2,tp=2"),
}
LAYER = {
    "dense_top1": dict(fn="dense", top_k=1),
    "dense_top2": dict(fn="dense", top_k=2),
    "sparse_ample": dict(fn="sparse", top_k=2, capacity_factor=4.0),
    "sparse_tight": dict(fn="sparse", top_k=2, capacity_factor=0.5),
}


def _layer_inputs():
    rng = np.random.default_rng(0)
    params = {
        "gate": (rng.standard_normal((D, E)) * 0.5).astype(np.float32),
        "w_in": (rng.standard_normal((E, D, F)) * 0.3).astype(np.float32),
        "w_out": (rng.standard_normal((E, F, D)) * 0.3).astype(np.float32),
    }
    return params, rng.standard_normal((N, D)).astype(np.float32)


def _jax_layer(case, spec):
    import jax
    import jax.numpy as jnp

    from pytorch_operator_tpu.parallel import make_mesh
    from pytorch_operator_tpu.parallel import moe as jax_moe

    params, x = _layer_inputs()
    n = int(np.prod([int(p.split("=")[1]) for p in spec.split(",")]))
    mesh = make_mesh(spec, devices=jax.devices()[:n])
    c = LAYER[case]

    def f(p, x):
        if c["fn"] == "dense":
            return jax_moe.moe_mlp(p, x, mesh=mesh, top_k=c["top_k"])
        return jax_moe.moe_mlp_sparse(p, x, mesh=mesh, top_k=c["top_k"],
                                      capacity_factor=c["capacity_factor"])

    p = {k: jnp.asarray(v) for k, v in params.items()}
    out = jax.jit(f)(p, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(lambda p, x: (f(p, x) ** 2).mean(), argnums=(0, 1)))(p, jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


@pytest.fixture(scope="module")
def init_tree():
    import flax.linen as nn
    import jax

    model = jax_llama.Llama(jax_llama.llama_tiny(n_experts=4))
    params = model.init(jax.random.key(0), np.zeros((1, KW["seq_len"]), np.int32))["params"]
    return jax.device_get(nn.meta.unbox(params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, init_tree):
    """JAX's training runs (2 and 4 devices, both subprocesses at once), the
    port's layer cases and training runs in a two-rank world, then in a
    four-rank one."""
    d = tmp_path_factory.mktemp("ep_runs")
    procs = {2: torch_worlds.start_jax_runs(TWO, 2, d / "two"),
             4: torch_worlds.start_jax_runs(FOUR, 4, d / "four")}
    params, x = _layer_inputs()
    layer = [dict(c, params=params, x=x) for c in LAYER.values()]
    ck = d / "port_ck"
    train_two = [dict(kw, init_params=init_tree) for kw in TWO.values()]
    train_two[0].update(env={"TPUJOB_CHECKPOINT_DIR": str(ck)}, checkpoint_every=1000)
    try:
        two = torch_worlds.run_world("many", [("moe", ("ep=2", layer)), ("train", (train_two,))])
        four = torch_worlds.run_world(
            "many", [("moe", ("ep=2,tp=2", layer[1:2])),
                     ("train", ([dict(kw, init_params=init_tree) for kw in FOUR.values()],)),
                     ("restore_layout", (str(ck), 3, "dp=2,ep=2", "adamw", {"n_experts": 4}))],
            n=4, timeout=300,
        )
        jax_runs = {**torch_worlds.finish_jax_runs(procs[2], d / "two"),
                    **torch_worlds.finish_jax_runs(procs[4], d / "four")}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    ranks = {name: [r[1][i] for r in two] for i, name in enumerate(TWO)}
    ranks.update({name: [r[1][i] for r in four] for i, name in enumerate(FOUR)})
    return {"jax": jax_runs, "ranks": ranks, "ck": ck,
            "layer": {name: [r[0][i] for r in two] for i, name in enumerate(LAYER)},
            "layer_tp": [r[0][0] for r in four], "restored": [r[2] for r in four]}


def _check_layer(ranks, want_out, want_grads, want_x):
    for r in ranks:
        np.testing.assert_allclose(r["out"], want_out, atol=ATOL_OUT, rtol=0)
        np.testing.assert_allclose(r["x"], want_x, atol=ATOL_GRAD, rtol=0, err_msg="x")
        np.testing.assert_allclose(r["gate"], want_grads["gate"], atol=ATOL_GRAD, rtol=0, err_msg="gate")
        e0, en, f0, fn = r["block"]
        np.testing.assert_allclose(r["w_in"], want_grads["w_in"][e0:e0 + en, :, f0:f0 + fn],
                                   atol=ATOL_GRAD, rtol=0, err_msg="w_in")
        np.testing.assert_allclose(r["w_out"], want_grads["w_out"][e0:e0 + en, f0:f0 + fn],
                                   atol=ATOL_GRAD, rtol=0, err_msg="w_out")


@pytest.mark.parametrize("case", sorted(LAYER))
def test_moe_layer_over_ep2_matches_jax(case, runs):
    _check_layer(runs["layer"][case], *_jax_layer(case, "ep=2"))
    assert [r["block"][:2] for r in runs["layer"][case]] == [(0, 2), (2, 2)]


def test_moe_under_tp_splits_each_experts_ff(runs):
    """ep=2,tp=2: each rank holds 2 experts' halves of F (the reference's
    tp split of each expert), the parts summed over ep and tp."""
    _check_layer(runs["layer_tp"], *_jax_layer("dense_top2", "ep=2,tp=2"))
    assert sorted(r["block"] for r in runs["layer_tp"]) == [(0, 2, 0, 16), (0, 2, 16, 16),
                                                            (2, 2, 0, 16), (2, 2, 16, 16)]


def _jax_params(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_jax(tree, port_llama.llama_tiny(n_experts=4)).items()}


CASES = {**TWO, **FOUR}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ep_world_matches_jax_run_on_the_same_mesh(case, runs):
    want, got = runs["jax"][case], runs["ranks"][case][0]
    n = 2 if case in TWO else 4
    np.testing.assert_allclose(got["final_loss"], want["result"]["final_loss"], rtol=1e-4)
    assert got["world"] == want["result"]["devices"] == n
    assert got["mesh"] == llama_train.resolve_train_mesh(CASES[case]["mesh_spec"], n)
    assert set(want["result"]) <= set(got), set(want["result"]) - set(got)
    assert (got["n_experts"], got["moe_dispatch"]) == (want["result"]["n_experts"], want["result"]["moe_dispatch"])
    jax_sd = _jax_params(want["params"])
    assert jax_sd.keys() == got["params"].keys()
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, jax_sd[name], atol=3e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ep_world_matches_one_process_step_for_step(case, init_tree, runs):
    """Every step's loss (and aux loss) as one process's on the whole batch;
    every rank gathers the same whole parameters; each rank holds half of
    the expert bytes."""
    kw = {k: v for k, v in CASES[case].items() if k != "mesh_spec"}
    one = llama_train.run(device="cpu", init_params=init_tree, log=lambda m: None, **kw)
    ranks = runs["ranks"][case]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-5)
    if "aux_losses" in one:
        np.testing.assert_allclose(ranks[0]["aux_losses"], one["aux_losses"], rtol=1e-5)
    for name in ranks[0]["params"]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["params"][name], ranks[0]["params"][name])
    whole = one["per_rank"][0]["expert_param_bytes"]
    per_rank = ranks[0]["per_rank"]
    share = {"ep_tp_dense": 4}.get(case, 2)
    assert [r["expert_param_bytes"] for r in per_rank] == [whole // share] * len(per_rank)
    assert ranks[0]["params_m"] == one["params_m"]


def test_ep2_checkpoint_restores_in_one_process_bit_for_bit(runs):
    """The ep=2 run's last step (each rank wrote its experts' rows) restored
    whole by one process: the world's final parameters, bit for bit."""
    import torch

    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager

    model = port_llama.Llama(port_llama.llama_tiny(n_experts=4))
    mgr = CheckpointManager(runs["ck"])
    step = mgr.latest_step()
    assert step == 3
    got = mgr.restore({"params": model.state_dict()})["params"]
    want = runs["ranks"]["ep_dense"][0]["params"]
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert isinstance(t, torch.Tensor) and not hasattr(t, "to_local")
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


def _held(blocks, whole=None) -> int:
    """The elements of a rank's blocks (each checked against its box of
    ``whole`` where given)."""
    n = 0
    for name, b in blocks.items():
        if isinstance(b, dict) and "offsets" not in b:
            n += _held(b, None if whole is None else whole[name])
        elif isinstance(b, dict):
            if whole is not None:
                box = tuple(slice(o, o + k) for o, k in zip(b["offsets"], b["data"].shape))
                np.testing.assert_array_equal(b["data"], whole[name][box], err_msg=name)
            n += b["data"].size
    return n


def test_ep2_checkpoint_restores_at_dp2_ep2_reading_only_a_ranks_blocks(runs):
    """The ep=2 step restored by four ranks at dp=2,ep=2: each rank's
    parameter blocks are the world's parameters' boxes bit for bit (its two
    experts, the rest whole), and it read exactly the elements of its
    blocks, less than the whole step."""
    whole = runs["ranks"]["ep_dense"][0]["params"]
    n_whole = sum(a.size for a in whole.values())
    for r in runs["restored"]:
        held = _held(r["params"], whole) + _held(r["opt"]["adamw"]["state"])
        assert r["read"] == held, (r["read"], held)
        assert r["read"] < 3 * n_whole
    experts = [b for r in runs["restored"] for n, b in r["params"].items() if n.endswith("moe_mlp.w_in")]
    assert sorted({b["offsets"][0] for b in experts}) == [0, 2]
