"""Sequence parallelism in the port's ``llama_train.run``: ``sp=2`` with
ring and with ulysses attention (two ranks), and ``sp=2,tp=2`` with ring
(four ranks), against the JAX package's ``llama_train.run`` on the same
mesh over as many virtual CPU devices, from the same init (the JAX Llama's
key-0 init, carried by ``params_from_jax``).

Each sp rank trains on its block of 16 of the rows' 32 positions; its
labels come from the whole rows. Tolerances are
``tests/test_torch_dist_train.py``'s: the final parameters within atol 3e-5
of JAX's, every step's loss within rtol 1e-5 of the port's one-process run
of the same global batch. The sp ranks' parameters are bit-equal after the
last step: the gradients are averaged over sp (without that mean each rank
would step on its own positions' gradient and drift apart).
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.workloads import llama_train
from tests import torch_worlds

KW = dict(config="tiny", batch_size=8, seq_len=32, steps=2, warmup=1, lr=3e-4)
TWO = {
    "sp_ring": dict(KW, mesh_spec="sp=2", attn_impl="ring"),
    "sp_ulysses": dict(KW, mesh_spec="sp=2", attn_impl="ulysses"),
}
FOUR = {
    "sp_tp_ring": dict(KW, mesh_spec="sp=2,tp=2", attn_impl="ring"),
}
CASES = {**TWO, **FOUR}


@pytest.fixture(scope="module")
def init_tree():
    import flax.linen as nn
    import jax

    model = jax_llama.Llama(jax_llama.llama_tiny())
    params = model.init(jax.random.key(0), np.zeros((1, KW["seq_len"]), np.int32))["params"]
    return jax.device_get(nn.meta.unbox(params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, init_tree):
    """JAX's runs (2 and 4 devices, both subprocesses at once) and the
    port's (a two-rank world, then a four-rank one)."""
    d = tmp_path_factory.mktemp("sp_runs")
    procs = {2: torch_worlds.start_jax_runs(TWO, 2, d / "two"),
             4: torch_worlds.start_jax_runs(FOUR, 4, d / "four")}
    try:
        two = torch_worlds.run_world("train", [dict(kw, init_params=init_tree) for kw in TWO.values()])
        four = torch_worlds.run_world("train", [dict(kw, init_params=init_tree) for kw in FOUR.values()],
                                      n=4, timeout=300)
        jax_runs = {**torch_worlds.finish_jax_runs(procs[2], d / "two"),
                    **torch_worlds.finish_jax_runs(procs[4], d / "four")}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    ranks = {name: [r[i] for r in two] for i, name in enumerate(TWO)}
    ranks.update({name: [r[i] for r in four] for i, name in enumerate(FOUR)})
    return {"jax": jax_runs, "ranks": ranks}


def _jax_params(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_jax(tree, port_llama.llama_tiny()).items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_world_matches_jax_run_on_the_same_mesh(case, runs):
    want, got = runs["jax"][case], runs["ranks"][case][0]
    n = 2 if case in TWO else 4
    np.testing.assert_allclose(got["final_loss"], want["result"]["final_loss"], rtol=1e-4)
    assert got["end_step"] == want["result"]["end_step"] == 3
    assert got["world"] == want["result"]["devices"] == n and got["backend"] == "gloo"
    assert got["mesh"] == llama_train.resolve_train_mesh(CASES[case]["mesh_spec"], n)
    assert set(want["result"]) <= set(got), set(want["result"]) - set(got)
    jax_sd = _jax_params(want["params"])
    assert jax_sd.keys() == got["params"].keys()
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, jax_sd[name], atol=3e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_world_matches_one_process_step_for_step(case, init_tree, runs):
    """Every step's loss as one process's on the whole batch (ring and
    ulysses run the dense f32 path there), and the sp ranks' parameters
    bit-equal after the last step."""
    kw = {k: v for k, v in CASES[case].items() if k != "mesh_spec"}
    one = llama_train.run(device="cpu", init_params=init_tree, log=lambda m: None, **kw)
    ranks = runs["ranks"][case]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-5)
    for name in ranks[0]["params"]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["params"][name], ranks[0]["params"][name], err_msg=name)


def test_sp_coordinates_and_bytes(runs):
    """Each sp rank holds every parameter whole (sp splits none) and reads
    the same rows; under sp=2,tp=2 the tp blocks halve the bytes."""
    sp = runs["ranks"]["sp_ring"][0]["per_rank"]
    assert [(r["data_index"], r["sp_index"], r["tp_index"]) for r in sp] == [(0, 0, 0), (0, 1, 0)]
    whole = 4 * sum(p.numel() for p in port_llama.Llama(port_llama.llama_tiny()).parameters())
    assert [r["param_bytes"] for r in sp] == [whole, whole]
    four = runs["ranks"]["sp_tp_ring"][0]["per_rank"]
    assert [(r["sp_index"], r["tp_index"]) for r in four] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["param_bytes"] < whole for r in four)
