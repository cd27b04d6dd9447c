"""The port's adafactor under a mesh (``trainer.Adafactor`` with ``mesh``):
worlds ``fsdp=2`` and ``tp=2`` of two spawned ranks over gloo.

- Against the JAX package's ``llama_train.run(optimizer="adafactor")`` on
  the same mesh over 2 virtual CPU devices, from the same key-0 init, in
  f32 and bf16 parameters (the tiny config, whose leaves optax leaves
  unfactored), lr 1e-2: the per-step losses within rtol 1e-5 of the port's
  one-process run; f32: the final loss within rtol 1e-4 of JAX's and the
  parameters within atol 3e-5 (``tests/test_torch_dist_train.py``'s); bf16:
  the parameters held against the one-process run's at
  ``tests/test_torch_adafactor.py``'s bf16 tolerances (each tensor's move
  within a relative L2 error of 10%, and at most 8% of a bf16 tensor's
  elements not bit-equal: the sums over the ranks run in another order),
  and the final loss no further from JAX's than the one-process
  run's own (1.3e-3 relative after three free-running steps: each step's
  rounding flips compound, which is why ``tests/test_torch_adafactor.py``
  holds the bf16 update teacher-forced) plus rtol 1e-4.
- Against optax on one device (``tests/test_torch_adafactor.py``'s wide
  tiny Llama, d_model 256 and heads of 128, so that q/k/v, o, the MLP, the
  embedding and the head are factored), three steps at lr 1e-2, at that
  file's tolerances: f32 free-running, every parameter after every step
  within atol 1e-6 and the final statistics, gathered from the ranks'
  blocks, within rtol 5e-5; bf16 teacher-forced (each step from JAX's
  parameters and state before it), the loss within rtol 1e-4, the norm
  scales within atol 1e-5, each bf16 leaf's update within a relative L2
  error of 10% with at most 8% of its elements not bit-equal.
- The planted fault: the row statistics (the mean over a factored leaf's
  largest dim) left unreduced over fsdp, which splits that dim of the
  MLP's gate/up ``[L, M, d_ff]`` and the head ``[M, V]``: parameters far
  above atol 1e-6.
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.workloads import llama_train
from tests import torch_worlds
from tests.test_torch_adafactor import B, LR, S, WIDE, _factored_state, _port_state, _setup
from tests.test_torch_tp_train import KW, finish_jax_runs, start_jax_runs

RUNS = {
    f"{mesh}_{dtype}": dict(KW, mesh_spec=f"{mesh}=2", optimizer="adafactor", lr=1e-2, param_dtype=dtype)
    for mesh in ("fsdp", "tp") for dtype in ("float32", "bfloat16")
}
MESHES = ("fsdp=2", "tp=2")
# AdamW on bf16 parameters under FSDP2 (whose units want one dtype: the f32
# norm scales are units of their own).
ADAMW_BF16 = dict(KW, mesh_spec="fsdp=2", param_dtype="bfloat16")


@pytest.fixture(scope="module")
def init_tree():
    import flax.linen as nn
    import jax

    from pytorch_operator_tpu.models import llama as jax_llama

    model = jax_llama.Llama(jax_llama.llama_tiny())
    params = model.init(jax.random.key(0), np.zeros((1, KW["seq_len"]), np.int32))["params"]
    return jax.device_get(nn.meta.unbox(params))


def _optax_steps(param_dtype: str, n_steps: int = 3):
    """optax's adafactor on one device on the wide config: the init tree,
    each step's batch and loss, JAX's parameters and port-format state
    before each step and after the last, and the final optax state."""
    import jax

    jstep, state, mesh, _, _ = _setup(param_dtype, {})
    init = jax.device_get(state["params"])
    batches, losses, before = [], [], []
    for i in range(n_steps):
        toks = llama_train.synthetic_bigram_batch(B, S, 256, i)
        before.append((jax.device_get(state["params"]), _port_state(jax.device_get(state["opt_state"]))))
        with mesh:
            state, loss = jstep(state, toks)
        batches.append(toks)
        losses.append(float(loss))
    return dict(init=init, batches=batches, losses=losses, before=before,
                after=jax.device_get(state["params"]), opt_state=jax.device_get(state["opt_state"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, init_tree):
    d = tmp_path_factory.mktemp("tp_adafactor")
    proc = start_jax_runs(RUNS, 2, d)
    try:
        optax_f32, optax_bf16 = _optax_steps("float32"), _optax_steps("bfloat16")
        wide = []
        for mesh in MESHES:
            wide.append(dict(mesh=mesh, cfg=WIDE, tree=optax_f32["init"], batches=optax_f32["batches"], lr=LR))
        for mesh in MESHES:
            wide.append(dict(mesh=mesh, cfg=dict(WIDE, param_dtype=torch.bfloat16), lr=LR,
                             batches=optax_bf16["batches"], teacher=optax_bf16["before"]))
        wide.append(dict(wide[0], plant="unreduced_rows"))
        world = torch_worlds.run_world("train", [dict(kw, init_params=init_tree) for kw in RUNS.values()]
                                       + [dict(ADAMW_BF16, init_params=init_tree)])
        ada = torch_worlds.run_world("adafactor", wide)
        jax_runs = finish_jax_runs(proc, d)
    finally:
        if proc.poll() is None:
            proc.kill()
    return {"jax": jax_runs, "port": dict(zip(RUNS, world[0])), "adamw_bf16": world[0][len(RUNS)], "ranks": ada,
            "optax": {"float32": optax_f32, "bfloat16": optax_bf16}}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_adafactor_world_matches_jax_run_on_the_same_mesh(case, init_tree, runs):
    want, got = runs["jax"][case], runs["port"][case]
    assert got["optimizer"] == "adafactor" and got["world"] == 2 and got["end_step"] == 3
    kw = {k: v for k, v in RUNS[case].items() if k != "mesh_spec"}
    one = llama_train.run(device="cpu", init_params=init_tree, log=lambda m: None, keep_params=True, **kw)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
    jax_loss = want["result"]["final_loss"]
    if case.endswith("bfloat16"):
        # Free-running bf16 drifts from optax by itself in one process (each
        # step's rounding flips compound; test_torch_adafactor.py holds the
        # bf16 update teacher-forced): the world adds nothing to that gap.
        own_gap = abs(one["final_loss"] - jax_loss)
        assert abs(got["final_loss"] - jax_loss) <= own_gap + 1e-4 * jax_loss, (got["final_loss"], one["final_loss"], jax_loss)
    else:
        np.testing.assert_allclose(got["final_loss"], jax_loss, rtol=1e-4)
    if case.endswith("float32"):
        jax_sd = params_from_jax(want["params"], port_llama.llama_tiny())
        for name, p in got["params"].items():
            np.testing.assert_allclose(p, jax_sd[name].numpy(), atol=3e-5, rtol=0, err_msg=name)
        return
    init = params_from_jax(init_tree, port_llama.llama_tiny(param_dtype=torch.bfloat16))
    for name, p in got["params"].items():
        mine = one["params"][name].float().numpy()
        # test_torch_adafactor.py's bf16 tolerances, the one-process run in
        # JAX's place: the move within 10% (relative L2) and, for a bf16
        # tensor, at most 8% of the elements not bit-equal. Free-running, the
        # f32 norm scales follow the flips of the bf16 weights (9e-5 after
        # three steps, of a 3e-2 move).
        z = init[name].float().numpy()
        err = np.linalg.norm(p - mine) / np.linalg.norm(mine - z)
        flipped = 0.0 if name.endswith("norm.weight") else (p != mine).mean()
        assert err <= 0.10 and flipped <= 0.08, (name, err, flipped)


def _assemble(ranks_state: list, path: str, key: str) -> np.ndarray:
    """The whole statistic from the ranks' blocks (each element written by
    exactly one rank)."""
    first = ranks_state[0]["adafactor"][path][key]
    whole = np.full(first["shape"], np.nan, np.float32)
    for st in ranks_state:
        b = st["adafactor"][path][key]
        if b["writer"]:
            box = tuple(slice(o, o + n) for o, n in zip(b["offsets"], b["data"].shape))
            assert np.isnan(whole[box]).all(), (path, key, "written twice")
            whole[box] = b["data"]
    assert not np.isnan(whole).any(), (path, key, "not covered")
    return whole


def _jax_sd(tree, param_dtype):
    cfg = port_llama.llama_tiny(**WIDE, param_dtype=getattr(torch, param_dtype))
    return {k: v.float().numpy() for k, v in params_from_jax(tree, cfg).items()}


@pytest.mark.parametrize("mesh", MESHES)
def test_adafactor_world_f32_matches_optax_on_one_device(mesh, runs):
    from tests.test_torch_adafactor import _by_path

    ref = runs["optax"]["float32"]
    i = MESHES.index(mesh)
    got = [r[i] for r in runs["ranks"]]
    np.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=1e-4)
    want = _jax_sd(ref["after"], "float32")
    for name, p in got[0]["params"][-1].items():
        np.testing.assert_allclose(p, want[name], atol=1e-6, rtol=0, err_msg=name)
    fs = _factored_state(ref["opt_state"])
    states = [r["state"] for r in got]
    assert states[0]["count"] == int(fs.count) == 3
    n_factored = 0
    for key in ("v_row", "v_col", "v"):
        for path, w in _by_path(getattr(fs, key)).items():
            whole = _assemble(states, path, key)
            assert whole.shape == w.shape, (path, key)
            np.testing.assert_allclose(whole, w, rtol=5e-5, atol=1e-30, err_msg=f"{path}/{key}")
            n_factored += key == "v_row" and w.shape != (1,)
    assert n_factored >= 7  # q, k, v, o, gate, up, down, embed, head: the wide leaves factor
    # Each rank holds a part of the statistics, not all of them.
    whole_bytes = sum(np.asarray(w).nbytes for k in ("v_row", "v_col", "v")
                      for w in _by_path(getattr(fs, k)).values())
    assert all(r["state_nbytes"] < whole_bytes for r in got)


@pytest.mark.parametrize("mesh", MESHES)
def test_adafactor_world_bf16_teacher_forced_matches_optax(mesh, runs):
    ref = runs["optax"]["bfloat16"]
    i = len(MESHES) + MESHES.index(mesh)
    got = runs["ranks"][0][i]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    for step in range(3):
        before = _jax_sd(ref["before"][step][0], "bfloat16")
        after = _jax_sd(ref["before"][step + 1][0] if step < 2 else ref["after"], "bfloat16")
        for name, p in got["params"][step].items():
            a, b, z = p, after[name], before[name]
            if name.endswith("norm.weight"):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=f"{name}, step {step}")
                continue
            if np.any(b != z):
                err = np.linalg.norm(a - b) / np.linalg.norm(b - z)
                assert err <= 0.10, (name, step, err)
            assert (a != b).mean() <= 0.08, (name, step, (a != b).mean())


def test_planted_unreduced_rows_break_the_update(runs):
    """The row statistics left unreduced over fsdp: the parameters after
    three steps far from optax's (the sound fsdp=2 run within 1e-6)."""
    want = _jax_sd(runs["optax"]["float32"]["after"], "float32")

    def gap(r):
        return max(float(np.abs(r["params"][-1][k] - want[k]).max()) for k in want)

    sound, fault = gap(runs["ranks"][0][0]), gap(runs["ranks"][0][-1])
    print(f"unreduced rows: parameters {fault:.3e} from optax's (sound {sound:.3e}, limit 1e-6)")
    assert sound <= 1e-6 < 10 * 1e-6 < fault, (sound, fault)


def test_bf16_parameters_train_in_an_fsdp_world(init_tree, runs):
    """``--param-dtype bfloat16`` in a world of two ranks (fsdp=2, AdamW):
    FSDP2 takes one parameter dtype a unit, so the f32 norm scales are units
    of their own; the losses follow one process's (rtol 1e-4: bf16 rounding
    of gradients summed in another order)."""
    kw = {k: v for k, v in ADAMW_BF16.items() if k != "mesh_spec"}
    one = llama_train.run(device="cpu", init_params=init_tree, log=lambda m: None, **kw)
    got = runs["adamw_bf16"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-4)
    assert all(r["param_bytes"] < one["param_bytes"] for r in got["per_rank"])
