"""``llama_train.run`` with sparse MoE dispatch in worlds whose ranks split
the tokens (``parallel/moe.py``'s token groups over ranks), against the JAX
package's ``llama_train.run`` on the same mesh over virtual CPU devices.

Tiny config, 4 experts, top 2, sparse dispatch at capacity factor 0.5 (about
half the routings dropped, which ones decided by the global groups), aux
weight 1e-2, seed 0's JAX init, AdamW, 1 + 2 steps of the global batch 8 ×
32 (one group of 256 tokens, or of 128 a microbatch): ``fsdp=2`` (flash
attention's plain version), ``sp=2`` with ring and with ulysses attention,
``fsdp=2`` with ``grad_accum=2`` (a microbatch holds JAX's rows: each rank
its share of the global batch's half), ``fsdp=2`` under ``--remat
--remat-policy dots`` (the forward, its gather with it, recomputed beside
FSDP2's collectives), dense dispatch with aux at ``fsdp=2`` with
``grad_accum=2`` (the load-balance statistics of a microbatch), and
on four ranks ``dp=2,ep=2`` and the pipeline beside a data axis: sparse
dispatch at aux weight 0 (JAX refuses the aux loss on a pp mesh) with dense
attention (JAX's pp with flash fails at trace on the CPU), 4 microbatches
of JAX's rows (2 rows, 64 tokens, one group a microbatch, one row a data
rank): ``dp=2,pp=2`` with GPipe, with 1F1B and with 1F1B under ``--remat
--remat-policy dots`` (the recompute's gather at the backward tick), and
``fsdp=2,pp=2`` with 1F1B (the gather beside FSDP2's).

Limits are the ep tests' (``tests/test_torch_ep.py``): final parameters
within atol 3e-5 of JAX's; every step's loss and aux loss within rtol 1e-5
of the port's one process on the whole batch and of JAX's (each recorded
around JAX's train step, the aux as JAX's loss function forms it). The pp
runs' losses hold within the pp tests' rtol 2e-5 of JAX's
(``tests/test_torch_pp_ep_sp_train.py``), and within rtol 1e-5 of the port's
one process with ``grad_accum`` 4, which splits the global batch into the
same microbatches and so forms the same groups. A planted fault, the feed
giving each data coordinate its own rows split into the microbatches,
misses JAX's losses. The feed's rows at ``dp=2,pp=2`` and ``fsdp=2,pp=2``
are JAX's microbatches' shares, and an impossible split raises JAX's error.
"""

import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu.parallel import pipeline as jax_pipeline
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.workloads import llama_train
from tests import torch_worlds

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL, PARAM_ATOL = 1e-5, 3e-5
KW = dict(config="tiny", batch_size=8, seq_len=32, steps=2, warmup=1, lr=3e-4, n_experts=4,
          moe_aux_weight=1e-2)
SPARSE = dict(KW, moe_dispatch="sparse", moe_capacity_factor=0.5)
TWO = {
    "fsdp": dict(SPARSE, mesh_spec="fsdp=2"),
    "sp_ring": dict(SPARSE, mesh_spec="sp=2", attn_impl="ring"),
    "sp_ulysses": dict(SPARSE, mesh_spec="sp=2", attn_impl="ulysses"),
    "fsdp_accum": dict(SPARSE, mesh_spec="fsdp=2", grad_accum=2),
    "fsdp_remat_dots": dict(SPARSE, mesh_spec="fsdp=2", remat=True, remat_policy="dots"),
    "dense_aux_accum": dict(KW, mesh_spec="fsdp=2", grad_accum=2),
}
PP = dict(SPARSE, moe_aux_weight=0.0, attn_impl="dense", pp_microbatches=4)
PP_CASES = {
    "dp_pp_gpipe": dict(PP, mesh_spec="dp=2,pp=2", pp_schedule="gpipe"),
    "dp_pp_1f1b": dict(PP, mesh_spec="dp=2,pp=2", pp_schedule="1f1b"),
    "fsdp_pp_1f1b": dict(PP, mesh_spec="fsdp=2,pp=2", pp_schedule="1f1b"),
    "dp_pp_remat_dots": dict(PP, mesh_spec="dp=2,pp=2", pp_schedule="1f1b", remat=True,
                             remat_policy="dots"),
}
FOUR = {"dp_ep": dict(SPARSE, mesh_spec="dp=2,ep=2"), **PP_CASES}
CASES = {**TWO, **FOUR}
# The pp tests' limit against JAX's losses.
PP_LOSS_RTOL = 2e-5
PP_FAULT = dict(PP_CASES["dp_pp_1f1b"], plant="pp_coordinate_rows")
FEED_MESHES = ("dp=2,pp=2", "fsdp=2,pp=2")

# JAX's runs, each step's loss recorded around its train step and its aux
# loss formed before it as JAX's loss function forms it (the mean over the
# layers' sown losses, a mean over the microbatches of grad_accum).
_JAX_RUNS = """
import os, pickle, sys
import tests.jaxenv
import jax
import jax.numpy as jnp
from pytorch_operator_tpu.checkpoint import CheckpointManager
from pytorch_operator_tpu.parallel import activation_rules
from pytorch_operator_tpu.workloads import llama_train, trainer
cases, out_dir, n = pickle.load(open(sys.argv[1], "rb")), sys.argv[2], int(sys.argv[3])
assert jax.device_count() == n, jax.devices()
losses, auxes = [], []
make = trainer.make_lm_train_step

want_aux = [True]

def recording(model, tx, mesh, *a, grad_accum=1, **kw):
    step = make(model, tx, mesh, *a, grad_accum=grad_accum, **kw)

    def aux_of(params, tokens):
        vals = []
        for tb in tokens.reshape(grad_accum, -1, tokens.shape[1]):
            with activation_rules(mesh):
                _, mods = model.apply({"params": params}, tb, mutable=["losses"], return_hidden=True)
            vals.append(jnp.mean(jnp.stack([a.mean() for a in jax.tree.leaves(mods["losses"])])))
        return jnp.mean(jnp.stack(vals))

    aux_fn = jax.jit(aux_of)

    def run(state, tokens):
        if want_aux[0]:
            auxes.append(float(aux_fn(state["params"], tokens)))
        state, loss = step(state, tokens)
        losses.append(float(jax.device_get(loss)))
        return state, loss

    return run

trainer.make_lm_train_step = recording
out = {}
for name, kw in cases.items():
    losses.clear()
    auxes.clear()
    want_aux[0] = kw.get("moe_aux_weight", 0) > 0
    ck = os.path.join(out_dir, "ck_" + name)
    os.environ["TPUJOB_CHECKPOINT_DIR"] = ck
    r = llama_train.run(log=lambda m: None, checkpoint_every=1000, **kw)
    _, params = CheckpointManager(ck, create=False).restore_subtree("params")
    r["losses"], r["aux_losses"] = list(losses), list(auxes)
    out[name] = {"result": r, "params": jax.tree.map(lambda a: a.astype("float32"), params)}
pickle.dump(out, open(os.path.join(out_dir, "jax.pkl"), "wb"))
"""


def _start_jax(cases: dict, n: int, d: Path):
    d.mkdir(parents=True, exist_ok=True)
    (d / "cases.pkl").write_bytes(pickle.dumps(cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
    return subprocess.Popen([sys.executable, "-c", _JAX_RUNS, str(d / "cases.pkl"), str(d), str(n)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def init_tree():
    import flax.linen as nn
    import jax

    model = jax_llama.Llama(jax_llama.llama_tiny(n_experts=4))
    params = model.init(jax.random.key(0), np.zeros((1, KW["seq_len"]), np.int32))["params"]
    return jax.device_get(nn.meta.unbox(params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, init_tree):
    """JAX's runs (2 and 4 devices, both subprocesses at once), the port's
    one-process runs of every case, then its worlds of two and four ranks."""
    d = tmp_path_factory.mktemp("moe_groups_runs")
    procs = {2: _start_jax(TWO, 2, d / "two"), 4: _start_jax(FOUR, 4, d / "four")}
    try:
        one = {
            name: llama_train.run(device="cpu", init_params=init_tree, log=lambda m: None, **_one_kw(kw))
            for name, kw in CASES.items()
        }
        two = torch_worlds.run_world("train", [dict(kw, init_params=init_tree) for kw in TWO.values()])
        four = torch_worlds.run_world("many", [
            ("train", ([dict(kw, init_params=init_tree) for kw in (*FOUR.values(), PP_FAULT)],)),
            ("pp_feed", (list(FEED_MESHES), 8, 4)),
        ], n=4, timeout=300)
        jax_runs = {}
        for n, proc in procs.items():
            _, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, err[-4000:]
            jax_runs.update(pickle.loads((d / {2: "two", 4: "four"}[n] / "jax.pkl").read_bytes()))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    ranks = {name: [r[i] for r in two] for i, name in enumerate(TWO)}
    ranks.update({name: [r[0][i] for r in four] for i, name in enumerate(FOUR)})
    return {"jax": jax_runs, "one": one, "ranks": ranks, "fault": [r[0][len(FOUR)] for r in four],
            "feed": [r[1] for r in four]}


def _one_kw(kw) -> dict:
    """One process's run of a case: without its mesh, and for a pp case
    without the pipeline's keys, accumulating over its microbatches
    instead (JAX's accumulation splits the global batch as its pipeline
    does)."""
    one = {k: v for k, v in kw.items() if k != "mesh_spec" and not k.startswith("pp_")}
    if "pp_microbatches" in kw:
        one["grad_accum"] = kw["pp_microbatches"]
    return one


def _jax_params(tree) -> dict:
    cfg = port_llama.llama_tiny(n_experts=4)
    return {k: v.numpy() for k, v in params_from_jax(tree, cfg).items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_world_matches_jax_run_on_the_same_mesh(case, runs):
    want, got = runs["jax"][case], runs["ranks"][case][0]
    n = 2 if case in TWO else 4
    assert got["world"] == want["result"]["devices"] == n
    assert got["mesh"] == llama_train.resolve_train_mesh(CASES[case]["mesh_spec"], n)
    assert len(want["result"]["losses"]) == len(got["losses"]) == 3
    rtol = PP_LOSS_RTOL if case in PP_CASES else LOSS_RTOL
    np.testing.assert_allclose(got["losses"], want["result"]["losses"], rtol=rtol)
    if CASES[case]["moe_aux_weight"] > 0:
        np.testing.assert_allclose(got["aux_losses"], want["result"]["aux_losses"], rtol=LOSS_RTOL)
    else:
        assert "aux_losses" not in got and want["result"]["aux_losses"] == []
    if case in PP_CASES:
        assert (got["pp_schedule"], got["pp_microbatches"]) == (CASES[case]["pp_schedule"], 4)
    assert got["moe_dispatch"] == want["result"]["moe_dispatch"]
    jax_sd = _jax_params(want["params"])
    assert jax_sd.keys() == got["params"].keys()
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, jax_sd[name], atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_world_matches_one_process_step_for_step(case, runs):
    """Every step's loss and aux loss as one process's on the whole batch
    (the same global groups and microbatches; a pp case's one process
    accumulates over its 4 microbatches); every rank gathers the same
    parameters."""
    one, ranks = runs["one"][case], runs["ranks"][case]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=LOSS_RTOL)
    if CASES[case]["moe_aux_weight"] > 0:
        np.testing.assert_allclose(ranks[0]["aux_losses"], one["aux_losses"], rtol=LOSS_RTOL)
    for name in ranks[0]["params"]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["params"][name], ranks[0]["params"][name])


def test_a_planted_coordinate_row_feed_misses_jax_on_a_pp_mesh(runs):
    """Each data coordinate's own rows split into the microbatches (the
    feed before JAX's microbatch rows) groups other tokens, drops other
    routings and leaves JAX's losses by more than ten times the limit."""
    want = runs["jax"]["dp_pp_1f1b"]["result"]["losses"]
    for got in runs["fault"]:
        gaps = [abs(a - b) / b for a, b in zip(got["losses"], want)]
        assert max(gaps) > 10 * PP_LOSS_RTOL, gaps


@pytest.mark.parametrize("spec", FEED_MESHES)
def test_pp_feed_gives_each_data_coordinate_its_share_of_jax_microbatches(spec, runs):
    """B8 in 4 microbatches of JAX's (rows 2m and 2m+1): the ranks at data
    coordinate d, on either stage, take rows 2m + d."""
    feeds = [r[FEED_MESHES.index(spec)] for r in runs["feed"]]
    assert sorted((f["data_index"], f["pp_index"]) for f in feeds) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for f in feeds:
        assert f["rows"] == [2 * m + f["data_index"] for m in range(4)], f


class _PipelineMesh:
    """What JAX's pipeline reads of a mesh before it checks the split."""

    shape = {"pp": 2}


@pytest.mark.parametrize("batch, microbatches", [(8, 0), (8, 3), (6, 3)])
def test_pp_microbatches_jax_cannot_split_raise_jax_error(batch, microbatches):
    """M < 1, M not dividing the global batch and M not a multiple of pp
    raise JAX's ValueError with its message, in its order."""
    x = np.zeros((batch, 4), np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_pipeline.pipeline_apply(None, None, x, mesh=_PipelineMesh(), microbatches=microbatches)
    with pytest.raises(ValueError, match=f"^{re.escape(str(jax_err.value))}$"):
        llama_train.check_pp_microbatches(batch, microbatches, 2, 2)


def test_pp_microbatches_a_data_extent_cannot_share_are_refused():
    """B8 in 4 microbatches of 2 rows cannot give 4 data coordinates equal
    shares of each; 2 can."""
    with pytest.raises(ValueError, match="the data extent 4 must divide each of the 4 microbatches' 2 rows"):
        llama_train.check_pp_microbatches(8, 4, 2, 4)
    assert llama_train.check_pp_microbatches(8, 4, 2, 2) == 4
