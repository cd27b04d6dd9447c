"""Pipeline stages beside expert and sequence parallelism, and beside fsdp
and tp together, in the port's ``llama_train.run``: ``pp=2,ep=2`` (the MoE
Llama's experts split over ep inside each stage, dense and sparse
dispatch), ``pp=2,sp=2`` with dense attention (every sp rank computes the
whole sequence; sparse dispatch too, which then groups a microbatch's
tokens as JAX's pipeline does), four ranks each, and on eight ranks
``fsdp=2,pp=2,tp=2`` with 1F1B (``tests/test_torch_pp_tp_train.py`` holds
``pp=2,tp=2``) and ``dp=2,pp=2,ep=2`` with sparse dispatch (a microbatch's
group over both data ranks' rows, the experts over ep). The tiny Llama at 4
layers with dense attention, B8 × 16, 2 steps, from JAX's key-0 init
carried by ``params_from_jax``.

Each against the JAX package's ``llama_train.run`` on the same mesh over as
many virtual CPU devices: every step's loss within rtol 2e-5, the final
parameters within atol 3e-5 (``tests/test_torch_pp_train.py``'s
tolerances), and against the port's one process (every loss within rtol
1e-5): on the whole batch with dense dispatch, and with sparse dispatch
accumulating over the pipeline's 4 microbatches (``grad_accum`` splits the
global batch as the pipeline does, so it forms the same groups). JAX's own
refusals stay, with its messages: ring and ulysses inside the pipeline at
``pp=2,sp=2``, and a MoE aux loss on a pp mesh beside ep.
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.workloads import llama_train
from tests import torch_worlds

KW = dict(config="tiny", n_layers=4, batch_size=8, seq_len=16, steps=2, warmup=1, lr=1e-3,
          attn_impl="dense", pp_schedule="1f1b")
MOE = dict(n_experts=4)
LOSS_RTOL, PARAM_ATOL, ONE_RTOL = 2e-5, 3e-5, 1e-5
FOUR = {
    "ep_dense": dict(KW, mesh_spec="pp=2,ep=2", **MOE),
    "ep_sparse": dict(KW, mesh_spec="pp=2,ep=2", moe_dispatch="sparse", **MOE),
    "sp_dense": dict(KW, mesh_spec="pp=2,sp=2", pp_schedule="gpipe"),
    "sp_sparse": dict(KW, mesh_spec="pp=2,sp=2", moe_dispatch="sparse", **MOE),
}
EIGHT = {
    "fsdp_pp_tp": dict(KW, mesh_spec="fsdp=2,pp=2,tp=2"),
    "dp_pp_ep_sparse": dict(KW, mesh_spec="dp=2,pp=2,ep=2", moe_dispatch="sparse", **MOE),
}
REFUSED = {
    "ring": (dict(KW, mesh_spec="pp=2,sp=2", attn_impl="ring"),
             "attn_impl='ring' cannot run inside the pp pipeline"),
    "ulysses": (dict(KW, mesh_spec="pp=2,sp=2", attn_impl="ulysses"),
                "attn_impl='ulysses' cannot run inside the pp pipeline"),
    "aux": (dict(KW, mesh_spec="pp=2,ep=2", moe_aux_weight=1e-2, **MOE),
            "moe_aux_weight is not supported on a pp mesh"),
}


ONE_CASES = sorted({**FOUR, **EIGHT})
# The pipeline's default microbatches (2·pp), which a sparse run's one
# process accumulates over.
PP_MICROBATCHES = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs on four and eight virtual devices (two subprocesses at
    once), the port's one-process references, a world of four ranks and
    one of eight."""
    d = tmp_path_factory.mktemp("pp_ep_sp_runs")
    procs = {4: torch_worlds.start_jax_recorded(FOUR, 4, d / "four"),
             8: torch_worlds.start_jax_recorded(EIGHT, 8, d / "eight")}
    try:
        dense, moe = torch_worlds.jax_init(), torch_worlds.jax_init(**MOE)

        def init_for(kw):
            return moe if kw.get("n_experts") else dense

        cases = {**FOUR, **EIGHT}
        one = {name: _one(cases[name], init_for(cases[name])) for name in ONE_CASES}
        four = [dict(kw, init_params=init_for(kw)) for kw in FOUR.values()]
        four += [dict(kw, init_params=init_for(kw), raises=ValueError) for kw, _ in REFUSED.values()]
        four = torch_worlds.run_world("train", four, n=4, timeout=400)
        eight = torch_worlds.run_world("train", [dict(kw, init_params=init_for(kw)) for kw in EIGHT.values()],
                                       n=8, timeout=400)
        jax_runs = {**torch_worlds.finish_jax_runs(procs[4], d / "four"),
                    **torch_worlds.finish_jax_runs(procs[8], d / "eight")}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    ranks = {name: [r[i] for r in four] for i, name in enumerate([*FOUR, *REFUSED])}
    ranks.update({name: [r[i] for r in eight] for i, name in enumerate(EIGHT)})
    return {"jax": jax_runs, "one": one, "ranks": ranks}


def _one(kw, init):
    """One process's run of ``kw`` without its mesh and pipeline keys; with
    sparse dispatch accumulating over the pipeline's microbatches, whose
    groups a pp run's sparse layers form (JAX's too, which the sparse runs
    match): one process on the whole batch groups its tokens otherwise and
    drops others at capacity."""
    if kw.get("moe_dispatch") == "sparse":
        kw = dict(kw, grad_accum=PP_MICROBATCHES)
    kw = {k: v for k, v in kw.items() if not k.startswith("pp_") and k != "mesh_spec"}
    r = llama_train.run(device="cpu", init_params=init, log=lambda m: None, keep_params=True, **kw)
    r["params"] = {k: v.float().numpy() for k, v in r["params"].items()}
    return r


@pytest.mark.parametrize("case", sorted({**FOUR, **EIGHT}))
def test_pp_world_beside_ep_sp_tp_matches_jax_run_on_the_same_mesh(case, runs):
    """Every step's loss and the final parameters as JAX's run on the same
    mesh, on every rank."""
    kw = {**FOUR, **EIGHT}[case]
    want, ranks = runs["jax"][case], runs["ranks"][case]
    n = 4 if case in FOUR else 8
    got = ranks[0]
    assert got["end_step"] == want["result"]["end_step"] == 3
    assert got["world"] == want["result"]["devices"] == n and got["backend"] == "gloo"
    assert got["mesh"] == llama_train.resolve_train_mesh(kw["mesh_spec"], n)
    assert set(want["result"]) <= set(got), set(want["result"]) - set(got)
    assert len(want["result"]["losses"]) == 3
    np.testing.assert_allclose(got["losses"], want["result"]["losses"], rtol=LOSS_RTOL)
    cfg = port_llama.llama_tiny(n_layers=4, n_experts=kw.get("n_experts", 0))
    jax_sd = {k: v.numpy() for k, v in params_from_jax(want["params"], cfg).items()}
    for r in ranks:
        assert r["losses"] == got["losses"]
        assert r["params"].keys() == jax_sd.keys()
        for name, p in r["params"].items():
            np.testing.assert_allclose(p, jax_sd[name], atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", ONE_CASES)
def test_pp_world_beside_ep_sp_tp_matches_one_process(case, runs):
    """Every step's loss as one process's on the same global batch (sparse
    dispatch: over the same microbatches), and the ranks' gathered
    parameters."""
    got, one = runs["ranks"][case][0], runs["one"][case]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=ONE_RTOL)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, one["params"][name], atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_each_rank_holds_its_experts_and_coordinates(runs):
    """At pp=2,ep=2 each rank holds E/ep experts of its stage's 2 layers;
    at fsdp=2,pp=2,tp=2 the eight ranks' coordinates follow the mesh's
    order (pp outermost, tp innermost)."""
    per = runs["ranks"]["ep_sparse"][0]["per_rank"]
    assert [(q["pp_index"], q["ep_index"]) for q in per] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    model = port_llama.Llama(port_llama.llama_tiny(n_layers=4, **MOE), device="meta")
    experts = sum(4 * p.numel() for n, p in model.named_parameters()
                  if n.startswith(("layers.0.", "layers.1.")) and n.endswith(("moe_mlp.w_in", "moe_mlp.w_out")))
    assert [q["expert_param_bytes"] for q in per] == [experts // 2] * 4
    sp = runs["ranks"]["sp_dense"][0]["per_rank"]
    assert [(q["pp_index"], q["sp_index"]) for q in sp] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    eight = runs["ranks"]["fsdp_pp_tp"][0]["per_rank"]
    assert [(q["pp_index"], q["data_index"], q["tp_index"]) for q in eight] == [
        (p, f, t) for p in range(2) for f in range(2) for t in range(2)]


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_jax_refuses_on_a_pp_mesh_stays_refused_with_its_message(case, runs):
    _, pattern = REFUSED[case]
    assert all(pattern in m for m in runs["ranks"][case]), runs["ranks"][case]
