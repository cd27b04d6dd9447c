"""Sequence parallelism in the port's ``llama_train.run``: ``sp=2`` with
ring and with ulysses attention (two ranks), and ``sp=2,tp=2`` with ring
and with ulysses (four ranks; the tiny config's 2 kv heads leave one a tp
rank, so ulysses swaps the global heads gathered over tp, as JAX's does),
ulysses also with ``grad_accum`` 2, remat ``dots`` and ``grad_clip`` 1.0,
and ``fsdp=2,sp=2,tp=2`` ulysses with adafactor (eight ranks), against the
JAX package's ``llama_train.run`` on the same mesh over as many
virtual CPU devices, from the same init (the JAX Llama's key-0 init,
carried by ``params_from_jax``).

Each sp rank trains on its block of 16 of the rows' 32 positions; its
labels come from the whole rows. Tolerances are
``tests/test_torch_dist_train.py``'s: the final parameters within atol 3e-5
of JAX's, every step's loss within rtol 1e-5 of the port's one-process run
of the same global batch. The sp ranks' parameters are bit-equal after the
last step: the gradients are averaged over sp (without that mean each rank
would step on its own positions' gradient and drift apart).

The four-rank world also runs the planted fault that keeps the global
heads' output at the sp coordinate instead of the tp coordinate (its
parameters far outside the limit), and a checkpoint round trip at
``sp=2,tp=2`` ulysses: the step written by the world restores in one
process to the world's gathered parameters bit for bit, and the world
resumed from it trains the next step as one uninterrupted process does.
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
ULYSSES_TP = dict(KW, mesh_spec="sp=2,tp=2", attn_impl="ulysses")
FOUR = {
    "sp_tp_ring": dict(KW, mesh_spec="sp=2,tp=2", attn_impl="ring"),
    "sp_tp_ulysses": ULYSSES_TP,
    "sp_tp_ulysses_accum_dots": dict(ULYSSES_TP, grad_accum=2, remat=True, remat_policy="dots",
                                     grad_clip=1.0),
}
EIGHT = {
    "fsdp_sp_tp_ulysses_adafactor": dict(ULYSSES_TP, mesh_spec="fsdp=2,sp=2,tp=2", optimizer="adafactor"),
}
CASES = {**TWO, **FOUR, **EIGHT}
# The ulysses tp gathers a rank issues over a run: q, k and v a layer a
# forward (2 layers, 3 steps), twice per microbatch under remat (the
# recompute gathers again).
TP_GATHERS = {"sp_tp_ulysses": 3 * 2 * 3, "sp_tp_ulysses_accum_dots": 3 * 2 * 2 * 2 * 3,
              "fsdp_sp_tp_ulysses_adafactor": 3 * 2 * 3}
# The checkpoint round trip: a save at the end of step 3, a resume that
# trains step 4.
RESUME = dict(ULYSSES_TP, steps=5, max_steps=4, checkpoint_every=100)


@pytest.fixture(scope="module")
def init_tree():
    import flax.linen as nn
    import jax

    model = jax_llama.Llama(jax_llama.llama_tiny())
    params = model.init(jax.random.key(0), np.zeros((1, KW["seq_len"]), np.int32))["params"]
    return jax.device_get(nn.meta.unbox(params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, init_tree):
    """JAX's runs (2, 4 and 8 devices, the subprocesses at once) and the
    port's (worlds of two, four and eight ranks)."""
    d = tmp_path_factory.mktemp("sp_runs")
    procs = {2: torch_worlds.start_jax_runs(TWO, 2, d / "two"),
             4: torch_worlds.start_jax_runs(FOUR, 4, d / "four"),
             8: torch_worlds.start_jax_runs(EIGHT, 8, d / "eight")}
    ck = {"TPUJOB_CHECKPOINT_DIR": str(d / "ck")}
    try:
        two = torch_worlds.run_world("train", [dict(kw, init_params=init_tree) for kw in TWO.values()])
        four = torch_worlds.run_world("train", [dict(kw, init_params=init_tree) for kw in FOUR.values()] + [
            dict(ULYSSES_TP, init_params=init_tree, plant="ulysses_sp_heads"),
            # Last: the checkpoint directory stays set for the rest of the world.
            dict(ULYSSES_TP, init_params=init_tree, checkpoint_every=1000, env=ck),
            dict(RESUME, init_params=init_tree),
        ], n=4, timeout=300)
        eight = torch_worlds.run_world("train", [dict(kw, init_params=init_tree) for kw in EIGHT.values()],
                                       n=8, timeout=300)
        jax_runs = {**torch_worlds.finish_jax_runs(procs[2], d / "two"),
                    **torch_worlds.finish_jax_runs(procs[4], d / "four"),
                    **torch_worlds.finish_jax_runs(procs[8], d / "eight")}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    ranks = {name: [r[i] for r in two] for i, name in enumerate(TWO)}
    ranks.update({name: [r[i] for r in four] for i, name in enumerate(FOUR)})
    ranks.update({name: [r[i] for r in eight] for i, name in enumerate(EIGHT)})
    fault, saved, resumed = ([r[len(FOUR) + i] for r in four] for i in range(3))
    return {"jax": jax_runs, "ranks": ranks, "fault": fault, "saved": saved, "resumed": resumed,
            "ck": d / "ck"}


def _jax_params(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_jax(tree, port_llama.llama_tiny()).items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sp_world_matches_jax_run_on_the_same_mesh(case, runs):
    want, got = runs["jax"][case], runs["ranks"][case][0]
    n = 2 if case in TWO else 4 if case in FOUR else 8
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


def _param_gap(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def test_planted_sp_coordinate_heads_break_the_parameters(runs):
    """Ulysses under tp keeping the global heads' output at the sp
    coordinate: the ranks (sp 0, tp 1) and (sp 1, tp 0) feed another head's
    attention into o_proj; the parameters move far from JAX's."""
    want = _jax_params(runs["jax"]["sp_tp_ulysses"]["params"])
    sound = _param_gap(runs["ranks"]["sp_tp_ulysses"][0]["params"], want)
    fault = _param_gap(runs["fault"][0]["params"], want)
    print(f"ulysses sp-coordinate heads fault: parameters {fault:.3e} from JAX's (sound {sound:.3e}, "
          "limit 3e-5)")
    assert sound <= 3e-5 < 10 * 3e-5 < fault, (sound, fault)


def test_tp_gathers_only_where_a_tp_ranks_kv_heads_do_not_split(runs):
    """Each rank's tp gathers of q, k and v: 3 a layer a forward (the remat
    recompute again) under sp=2,tp=2 ulysses with one kv head a tp rank;
    none for the ring, nor for ulysses without tp."""
    for case in CASES:
        want = TP_GATHERS.get(case, 0)
        per_rank = runs["ranks"][case][0]["per_rank"]
        assert [r["tp_head_gathers"] for r in per_rank] == [want] * len(per_rank), case


def test_checkpoint_round_trip_at_sp2_tp2_ulysses(init_tree, runs):
    """The step written by the sp=2,tp=2 ulysses world restores in one
    process to the world's gathered parameters bit for bit (the tp blocks
    are those of any tp=2 layout); the world resumed from it trains step 4
    as one uninterrupted process does (rtol 1e-5)."""
    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager

    saved, resumed = runs["saved"][0], runs["resumed"][0]
    assert saved["end_step"] == 3 and resumed["end_step"] == 4 and len(resumed["losses"]) == 1
    step, params = CheckpointManager(runs["ck"], create=False).restore_subtree("params")
    assert step == 4 and params.keys() == saved["params"].keys()
    step3 = CheckpointManager(runs["ck"], create=False).restore({"params": None}, step=3)["params"]
    for name, t in step3.items():
        np.testing.assert_array_equal(t.numpy(), saved["params"][name], err_msg=name)
        np.testing.assert_array_equal(saved["params"][name], runs["ranks"]["sp_tp_ulysses"][0]["params"][name],
                                      err_msg=name)
    for name, t in params.items():
        np.testing.assert_array_equal(t.numpy(), resumed["params"][name], err_msg=name)
    kw = {k: v for k, v in RESUME.items() if k not in ("mesh_spec", "checkpoint_every")}
    one = llama_train.run(device="cpu", init_params=init_tree, log=lambda m: None, **kw)
    assert one["end_step"] == 4
    np.testing.assert_allclose(resumed["losses"], one["losses"][3:], rtol=1e-5)
