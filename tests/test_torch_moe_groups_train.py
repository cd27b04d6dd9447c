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
``dp=2,ep=2`` on four ranks.

Limits are the ep tests' (``tests/test_torch_ep.py``): final parameters
within atol 3e-5 of JAX's; every step's loss and aux loss within rtol 1e-5
of the port's one process on the whole batch and of JAX's (each recorded
around JAX's train step, the aux as JAX's loss function forms it). A sparse
run on ``pp`` beside a data axis is refused by name (ROADMAP item 3c-3c).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from pytorch_operator_tpu.models import llama as jax_llama
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
FOUR = {"dp_ep": dict(SPARSE, mesh_spec="dp=2,ep=2")}
CASES = {**TWO, **FOUR}
PP_DATA = dict(SPARSE, moe_aux_weight=0.0, mesh_spec="dp=2,pp=2", raises=NotImplementedError)

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
            name: llama_train.run(device="cpu", init_params=init_tree, log=lambda m: None,
                                  **{k: v for k, v in kw.items() if k != "mesh_spec"})
            for name, kw in CASES.items()
        }
        two = torch_worlds.run_world("train", [dict(kw, init_params=init_tree) for kw in TWO.values()])
        four = torch_worlds.run_world(
            "train", [dict(kw, init_params=init_tree) for kw in (*FOUR.values(), PP_DATA)],
            n=4, timeout=300,
        )
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
    ranks.update({name: [r[i] for r in four] for i, name in enumerate(FOUR)})
    return {"jax": jax_runs, "one": one, "ranks": ranks, "refused": [r[len(FOUR)] for r in four]}


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
    np.testing.assert_allclose(got["losses"], want["result"]["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["aux_losses"], want["result"]["aux_losses"], rtol=LOSS_RTOL)
    assert got["moe_dispatch"] == want["result"]["moe_dispatch"]
    jax_sd = _jax_params(want["params"])
    assert jax_sd.keys() == got["params"].keys()
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, jax_sd[name], atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_world_matches_one_process_step_for_step(case, runs):
    """Every step's loss and aux loss as one process's on the whole batch
    (the same global groups and microbatches); every rank gathers the same
    parameters."""
    one, ranks = runs["one"][case], runs["ranks"][case]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0]["aux_losses"], one["aux_losses"], rtol=LOSS_RTOL)
    for name in ranks[0]["params"]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["params"][name], ranks[0]["params"][name])


def test_sparse_on_pp_beside_a_data_axis_is_refused_by_name(runs):
    for msg in runs["refused"]:
        assert "ROADMAP.md item 3c-3c" in msg and "dp=2" in msg, msg
