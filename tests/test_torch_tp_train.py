"""Tensor parallelism in the port's ``llama_train.run``: worlds ``tp=2``
(two ranks), ``fsdp=2,tp=2`` and ``dp=2,tp=2`` (four ranks) against the JAX
package's ``llama_train.run`` on the same mesh over as many virtual CPU
devices, from the same init (the JAX Llama's key-0 init, each rank's tp
block carried by ``params_from_jax``).

Each JAX mesh runs in a subprocess whose XLA client has exactly as many
devices as the world has ranks (2 or 4); both start at once, and each
returns its final parameters through its own checkpoint. The port's ranks
run over gloo (``tests/torch_worlds.py``). Tolerances are
``tests/test_torch_dist_train.py``'s: the final loss within rtol 1e-4,
every parameter within atol 3e-5 (a tenth of the learning rate); the
world's per-step losses against the port's one-process run of the same
global batch within rtol 1e-5. Cases: dense attention and loss, flash (the
plain version here, Pallas in interpret mode on JAX's side) with the
chunked loss, ``grad_clip`` 1.0, ``grad_accum`` 2 and remat ``dots``.

The planted fault: tp's leave written with ``psum_autograd`` (its backward
sums over tp too, so every gradient upstream of a row-parallel product is
multiplied by tp) reads far above the parameters' limit.
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
KW = dict(config="tiny", batch_size=8, seq_len=32, steps=2, warmup=1, lr=3e-4)
FLASH = dict(attn_impl="flash", xent_impl="chunked")
TWO = {
    "tp_dense": dict(KW, mesh_spec="tp=2"),
    "tp_flash": dict(KW, mesh_spec="tp=2", **FLASH),
    "tp_clip": dict(KW, mesh_spec="tp=2", grad_clip=1.0),
    "tp_accum": dict(KW, mesh_spec="tp=2", grad_accum=2),
    "tp_remat_dots": dict(KW, mesh_spec="tp=2", remat=True, remat_policy="dots"),
}
FOUR = {
    "fsdp_tp_dense": dict(KW, mesh_spec="fsdp=2,tp=2"),
    "fsdp_tp_flash_clip": dict(KW, mesh_spec="fsdp=2,tp=2", grad_clip=1.0, **FLASH),
    "fsdp_tp_accum_dots": dict(KW, mesh_spec="fsdp=2,tp=2", grad_accum=2, remat=True,
                               remat_policy="dots"),
    "dp_tp_dense": dict(KW, mesh_spec="dp=2,tp=2"),
    "dp_tp_flash_accum_clip": dict(KW, mesh_spec="dp=2,tp=2", grad_accum=2, grad_clip=1.0, **FLASH),
}
CASES = {**TWO, **FOUR}

# Runs JAX's llama_train.run of each case; its final parameters come back
# through its checkpoint.
JAX_RUNS = """
import os, pickle, sys
import tests.jaxenv
from pytorch_operator_tpu.checkpoint import CheckpointManager
from pytorch_operator_tpu.workloads import llama_train
import jax
cases, out_dir, n = pickle.load(open(sys.argv[1], "rb")), sys.argv[2], int(sys.argv[3])
assert jax.device_count() == n, jax.devices()
out = {}
for name, kw in cases.items():
    ck = os.path.join(out_dir, "ck_" + name)
    os.environ["TPUJOB_CHECKPOINT_DIR"] = ck
    r = llama_train.run(log=lambda m: None, checkpoint_every=1000, **kw)
    _, params = CheckpointManager(ck, create=False).restore_subtree("params")
    out[name] = {"result": r, "params": jax.tree.map(lambda a: a.astype("float32"), params)}
pickle.dump(out, open(os.path.join(out_dir, "jax.pkl"), "wb"))
"""


def start_jax_runs(cases: dict, n_devices: int, d: Path) -> subprocess.Popen:
    """Start JAX's runs of ``cases`` in a subprocess with ``n_devices``
    virtual CPU devices; its results land in ``d/jax.pkl``."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "cases.pkl").write_bytes(pickle.dumps(cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}")
    return subprocess.Popen(
        [sys.executable, "-c", JAX_RUNS, str(d / "cases.pkl"), str(d), str(n_devices)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def finish_jax_runs(proc: subprocess.Popen, d: Path, timeout: float = 400) -> dict:
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return pickle.loads((d / "jax.pkl").read_bytes())


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
    port's (a two-rank world, then a four-rank one), and the planted
    fault's run in the two-rank world."""
    d = tmp_path_factory.mktemp("tp_runs")
    procs = {2: start_jax_runs(TWO, 2, d / "two"), 4: start_jax_runs(FOUR, 4, d / "four")}
    try:
        two = torch_worlds.run_world("train", [
            *(dict(kw, init_params=init_tree) for kw in TWO.values()),
            dict(TWO["tp_dense"], init_params=init_tree, plant="leave_psum_autograd"),
        ])
        four = torch_worlds.run_world(
            "train", [dict(kw, init_params=init_tree) for kw in FOUR.values()]
            + [dict(KW, mesh_spec="tp=4", raises=NotImplementedError)], n=4, timeout=300,
        )
        jax_runs = {**finish_jax_runs(procs[2], d / "two"), **finish_jax_runs(procs[4], d / "four")}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    port = {**dict(zip(TWO, two[0])), **dict(zip(FOUR, four[0]))}
    ranks = {name: [r[i] for r in two] for i, name in enumerate(TWO)}
    ranks.update({name: [r[i] for r in four] for i, name in enumerate(FOUR)})
    return {"jax": jax_runs, "port": port, "fault": two[0][len(TWO)], "ranks": ranks,
            "refused": four[0][len(FOUR)]}


def _jax_params(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_jax(tree, port_llama.llama_tiny()).items()}


def _param_gap(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_world_matches_jax_run_on_the_same_mesh(case, runs):
    want, got = runs["jax"][case], runs["port"][case]
    n = 2 if case in TWO else 4
    np.testing.assert_allclose(got["final_loss"], want["result"]["final_loss"], rtol=1e-4)
    assert got["end_step"] == want["result"]["end_step"] == 3
    assert got["devices"] == want["result"]["devices"] == got["world"] == n
    assert got["backend"] == "gloo"
    assert got["mesh"] == llama_train.resolve_train_mesh(CASES[case]["mesh_spec"], n)
    jax_sd = _jax_params(want["params"])
    assert jax_sd.keys() == got["params"].keys()
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, jax_sd[name], atol=3e-5, rtol=0, err_msg=name)


def _one_process(init_tree, case: str) -> dict:
    kw = {k: v for k, v in CASES[case].items() if k != "mesh_spec"}
    return llama_train.run(device="cpu", init_params=init_tree, log=lambda m: None, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_world_matches_one_process_step_for_step(case, init_tree, runs):
    """The world trains as one process does on the whole batch: every
    step's loss; every rank gathers the same whole parameters."""
    one = _one_process(init_tree, case)
    np.testing.assert_allclose(runs["port"][case]["losses"], one["losses"], rtol=1e-5)
    ranks = runs["ranks"][case]
    for name in ranks[0]["params"]:
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["params"][name], ranks[0]["params"][name])


def test_tp_layout_of_the_state(init_tree, runs):
    """Per-rank bytes under tp=2: half of each split tensor plus the whole
    norms, half of AdamW's moments of them; under fsdp=2,tp=2 a quarter
    (FSDP2's rows of each block); under dp=2,tp=2 the tp=2 share. The
    ranks' coordinates: tp=2 is one data coordinate, fsdp=2,tp=2 two of
    two tp ranks each. Launches: the plain version on the CPU (none)."""
    cfg = port_llama.llama_tiny()
    model = port_llama.Llama(cfg)
    norms = sum(p.numel() for n, p in model.named_parameters() if n.endswith("norm.weight"))
    total = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    tp = runs["port"]["tp_dense"]["per_rank"]
    assert [(r["data_index"], r["tp_index"]) for r in tp] == [(0, 0), (0, 1)]
    want = 4 * ((total - norms) // 2 + norms)
    assert [r["param_bytes"] for r in tp] == [want, want]
    assert all(r["optimizer_state_bytes"] == 2 * want + 4 * n_tensors for r in tp)
    four = runs["port"]["fsdp_tp_dense"]["per_rank"]
    assert [(r["data_index"], r["tp_index"]) for r in four] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["param_bytes"] == want // 2 for r in four)
    dp = runs["port"]["dp_tp_dense"]["per_rank"]
    assert [(r["data_index"], r["tp_index"]) for r in dp] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["param_bytes"] == want for r in dp)
    assert runs["port"]["tp_dense"]["params_m"] == round(total / 1e6, 1)
    for case in CASES:
        for r in runs["port"][case]["per_rank"]:
            assert r["flash_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_planted_leave_fault_breaks_the_parameters(runs):
    """tp's leave with psum_autograd's summing backward: the parameters
    move away from JAX's by far more than the limit (the losses of steps 2
    and 3 too)."""
    want = _jax_params(runs["jax"]["tp_dense"]["params"])
    sound = _param_gap(runs["port"]["tp_dense"]["params"], want)
    fault = _param_gap(runs["fault"]["params"], want)
    print(f"leave fault: parameters {fault:.3e} from JAX's (sound {sound:.3e}, limit 3e-5)")
    assert sound <= 3e-5 < 10 * 3e-5 < fault, (sound, fault)


def test_a_tp_that_does_not_divide_the_kv_heads_is_refused_by_name(runs):
    """tp=4 over the tiny Llama's 2 kv heads: refused, naming the dimension
    and the Queue 1 item (JAX runs it, XLA replicating what does not
    divide)."""
    msg = runs["refused"]
    assert "tp=4 does not divide n_kv_heads=2" in msg and "ROADMAP.md Queue 1" in msg, msg
