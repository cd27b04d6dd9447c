"""The port's multi-process training (``llama_train.run`` in a world of two
processes: FSDP2 over ``fsdp``, HSDP over ``dp``) against the JAX package's
``llama_train.run`` on the same mesh over 2 virtual CPU devices, from the
same init (the JAX Llama's key-0 init, carried with ``params_from_jax``).

The JAX side runs in a subprocess whose XLA client has exactly 2 devices
(this process's has 8, and a mesh takes them all); its final parameters come
back through its own checkpoint (``restore_subtree("params")``). The port
side runs in worlds of two spawned ranks over gloo (``tests/torch_worlds.py``).
Tolerances are those of ``tests/test_torch_llama_train.py``: the final loss
within rtol 1e-4 (JAX's result rounds it to 4 decimals, 2e-5 at these
losses), every parameter within atol 3e-5 (a tenth of the learning rate);
the two-rank runs' per-step losses against the port's one-process run on
the same global batch within rtol 1e-5 (f32, sums in another order).
"""

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.workloads import llama_train
from tests import torch_worlds

ROOT = Path(__file__).resolve().parents[1]
KW = dict(config="tiny", batch_size=8, seq_len=32, steps=2, warmup=1, lr=3e-4)
CASES = {
    "fsdp": dict(KW, mesh_spec="fsdp=2"),
    "dp": dict(KW, mesh_spec="dp=2"),
    "fsdp_accum_clip": dict(KW, mesh_spec="fsdp=2", grad_accum=2, grad_clip=1.0),
    # Remat under FSDP2: the block's all-gather runs inside the checkpointed
    # call and again in the recompute; dots' policy must neither save nor
    # change what it gathers.
    "fsdp_remat_dots": dict(KW, mesh_spec="fsdp=2", remat=True, remat_policy="dots"),
}

_JAX_RUNS = """
import os, pickle, sys
import tests.jaxenv
from pytorch_operator_tpu.checkpoint import CheckpointManager
from pytorch_operator_tpu.workloads import llama_train
import jax
assert jax.device_count() == 2, jax.devices()
cases, out_dir = pickle.load(open(sys.argv[1], "rb")), sys.argv[2]
out = {}
for name, kw in cases.items():
    ck = os.path.join(out_dir, "ck_" + name)
    os.environ["TPUJOB_CHECKPOINT_DIR"] = ck
    r = llama_train.run(log=lambda m: None, checkpoint_every=1000, **kw)
    _, params = CheckpointManager(ck, create=False).restore_subtree("params")
    out[name] = {"result": r, "params": params}
pickle.dump(out, open(os.path.join(out_dir, "jax.pkl"), "wb"))
"""


FSDP_WORLD = ("fsdp", "fsdp_accum_clip", "fsdp_remat_dots")


@pytest.fixture(scope="module")
def init_tree():
    import flax.linen as nn
    import jax

    model = jax_llama.Llama(jax_llama.llama_tiny())
    params = model.init(jax.random.key(0), np.zeros((1, KW["seq_len"]), np.int32))["params"]
    return jax.device_get(nn.meta.unbox(params))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX ``llama_train.run`` of each case on its mesh over 2 devices."""
    d = tmp_path_factory.mktemp("jax_runs")
    (d / "cases.pkl").write_bytes(pickle.dumps(CASES))
    env = dict(__import__("os").environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_RUNS, str(d / "cases.pkl"), str(d)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return pickle.loads((d / "jax.pkl").read_bytes())


@pytest.fixture(scope="module")
def port_runs(init_tree):
    """The port's runs of each case, each mesh in its own two-rank world."""
    runs = {}
    fsdp = torch_worlds.run_world(
        "train", [dict(CASES[c], init_params=init_tree) for c in FSDP_WORLD]
    )
    dp = torch_worlds.run_world("train", [dict(CASES["dp"], init_params=init_tree)] + [
        dict(KW, mesh_spec="fsdp=2", raises=NotImplementedError, **over) for over in REFUSED
    ])
    runs.update(zip(FSDP_WORLD, fsdp[0]))
    runs["dp"] = dp[0][0]
    runs["refused"] = dp[0][1:]
    runs["ranks"] = {"fsdp": fsdp, "dp": dp}
    return runs


# What a world of more than one process refuses, naming item 3c-2 (adafactor
# runs in a world since tensor parallelism's slice: tests/test_torch_tp_*.py).
REFUSED = [dict(n_experts=4), dict(attn_impl="ulysses"), dict(attn_impl="ring")]


def test_what_waits_for_item_3c_is_refused_in_a_world(port_runs):
    msgs = port_runs["refused"]
    assert len(msgs) == len(REFUSED)
    assert all("ROADMAP.md item 3c-2" in m for m in msgs), msgs
    assert "--experts in a world of 2 processes" in msgs[0]
    assert "ulysses" in msgs[1]


@pytest.mark.parametrize(
    "spec,error",
    [("fsdp=2", ValueError), ("dp=2", ValueError), ("fsdp=-1", None), ("dp=1,fsdp=1", None),
     ("dp=1@dcn,fsdp=-1", None), ("ep=1", NotImplementedError), ("sp=-1", NotImplementedError)],
)
def test_mesh_specs_in_a_world_of_one(spec, error):
    """One process: a mesh of one rank runs as before; a spec that wants
    more ranks than the world has raises as JAX's does; an axis beyond dp
    and fsdp is refused whatever its size."""
    if error is None:
        r = llama_train.run(device="cpu", mesh_spec=spec, log=lambda m: None,
                            **dict(KW, steps=1, batch_size=2, seq_len=8))
        assert r["world"] == 1 and r["backend"] is None and set(r["mesh"].values()) == {1}
    else:
        with pytest.raises(error):
            llama_train.run(device="cpu", mesh_spec=spec, log=lambda m: None, **KW)


def _one_process(init_tree, **kw):
    r = llama_train.run(device="cpu", init_params=init_tree, log=lambda m: None, keep_params=True, **kw)
    return r, {name: t.numpy() for name, t in r.pop("params").items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_jax_run_on_the_same_mesh(case, jax_runs, port_runs):
    want, got = jax_runs[case], port_runs[case]
    np.testing.assert_allclose(got["final_loss"], want["result"]["final_loss"], rtol=1e-4)
    assert got["end_step"] == want["result"]["end_step"] == 3
    assert got["devices"] == want["result"]["devices"] == 2
    assert got["world"] == 2 and got["backend"] == "gloo"
    assert got["mesh"] == ({"dp": 2} if case == "dp" else {"fsdp": 2})
    jax_sd = params_from_jax(want["params"], port_llama.llama_tiny())
    assert jax_sd.keys() == got["params"].keys()
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, jax_sd[name].numpy(), atol=3e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_one_process_step_for_step(case, init_tree, port_runs):
    """The global batch split over two ranks trains as the whole batch in
    one process: every step's loss, and both ranks hold the same gathered
    parameters."""
    kw = {k: v for k, v in CASES[case].items() if k != "mesh_spec"}
    one, kept = _one_process(init_tree, **kw)
    got = port_runs[case]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
    for name in kept:
        np.testing.assert_allclose(got["params"][name], kept[name], atol=3e-5, rtol=0, err_msg=name)
    ranks = port_runs["ranks"]["dp" if case == "dp" else "fsdp"]
    i = 0 if case == "dp" else FSDP_WORLD.index(case)
    for name in kept:
        np.testing.assert_array_equal(ranks[0][i]["params"][name], ranks[1][i]["params"][name])


def test_fsdp_shards_state_and_dp_replicates_it(init_tree, port_runs):
    """Per-rank bytes: under fsdp=2 each rank holds half the parameters and
    half of AdamW's moments (FSDP2's dim-0 shards: 32 of 64 rows, or 128 of
    256), under dp=2 all of them; the flash kernel's plain version ran in
    each rank, once a layer a step."""
    one, _ = _one_process(init_tree, **KW)
    fsdp = port_runs["fsdp"]["per_rank"]
    dp = port_runs["dp"]["per_rank"]
    assert [r["rank"] for r in fsdp] == [0, 1]
    assert sum(r["param_bytes"] for r in fsdp) == one["param_bytes"]
    assert all(r["param_bytes"] == one["param_bytes"] // 2 for r in fsdp)
    moments = one["optimizer_state_bytes"] - 4 * len(list(_one_param_names()))  # less the step scalars
    assert all(r["optimizer_state_bytes"] - 4 * len(list(_one_param_names())) == moments // 2 for r in fsdp)
    assert all(r["param_bytes"] == one["param_bytes"] for r in dp)
    assert all(r["optimizer_state_bytes"] == one["optimizer_state_bytes"] for r in dp)
    n_layers = port_llama.llama_tiny().n_layers
    for r in fsdp + dp:
        assert r["flash_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert port_runs["fsdp"]["flash_launches_per_step"] == one["flash_launches_per_step"]
    assert n_layers == 2


def _one_param_names():
    return port_llama.Llama(port_llama.llama_tiny()).state_dict().keys()
