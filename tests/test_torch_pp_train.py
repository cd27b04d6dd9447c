"""Pipeline parallelism in the port's ``llama_train.run``: ``pp=2`` with
GPipe and 1F1B (two ranks), ``dp=2,pp=2`` and ``fsdp=2,pp=2`` (four
ranks), against the JAX package's ``llama_train.run`` on the same mesh over
as many virtual CPU devices, from the same init (the JAX Llama's key-0
init, carried by ``params_from_jax``), the tiny Llama at 4 layers with dense
attention (``tests/test_llama_pp.py``'s model).

The GPipe and 1F1B runs with the dense and the chunked loss, and the four-rank
meshes, are held against JAX's run; remat, 8 microbatches, the MoE Llama
(aux weight 0), adafactor and bf16 parameters against the port's one
process, which the other port tests hold against JAX.

Tolerances: every step's loss within rtol 2e-5 of JAX's (JAX's own
tolerance against the sequential run, ``tests/test_llama_pp.py:72``; the
JAX run's losses are recorded step by step around its train step) and of
the port's one-process run; the final parameters within atol 3e-5 of
JAX's (``tests/test_torch_dist_train.py``'s). bf16 parameters: every loss
within 2e-3 nats of one process's (the stages' gradients are sums of
microbatch gradients in bf16, one process's one backward's; readings
below 1e-3).

Also, against one process: adafactor over pp, eval on a pp mesh, a
vocabulary that pp does not divide (the head on the last stage, JAX's
warning); the checkpoint of a pp world restored whole by one process and
by an fsdp=2 world, a pp world resumed from its own step (AdamW's state
keyed by each parameter's index in the whole model) bit for bit against an
uninterrupted run, one-process steps (adafactor and AdamW) restored by pp
ranks that read only their own tensors, and a step with a layer more than
the model refused by fsdp and pp ranks; a planted pipeline fault; the
refusals.
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
from pytorch_operator_tpu_torch.checkpoint import CheckpointManager
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.workloads import llama_train
from tests import torch_worlds

ROOT = Path(__file__).resolve().parents[1]
KW = dict(config="tiny", n_layers=4, batch_size=8, seq_len=16, steps=2, warmup=1, lr=1e-3,
          attn_impl="dense")
LOSS_RTOL, PARAM_ATOL, BF16_ATOL = 2e-5, 3e-5, 2e-3
# Against JAX's run on the same mesh.
TWO = {
    "gpipe_dense": dict(KW, mesh_spec="pp=2", pp_schedule="gpipe", xent_impl="dense"),
    "gpipe_chunked": dict(KW, mesh_spec="pp=2", pp_schedule="gpipe", xent_impl="chunked"),
    "1f1b_dense": dict(KW, mesh_spec="pp=2", pp_schedule="1f1b", xent_impl="dense"),
    "1f1b_chunked": dict(KW, mesh_spec="pp=2", pp_schedule="1f1b", xent_impl="chunked"),
}
FOUR = {
    "dp_pp": dict(KW, mesh_spec="dp=2,pp=2"),
    "fsdp_pp": dict(KW, mesh_spec="fsdp=2,pp=2", pp_schedule="1f1b"),
}
# Against one process only.
PORT_ONLY = {
    "1f1b_remat": dict(KW, mesh_spec="pp=2", pp_schedule="1f1b", remat=True),
    # 8 microbatches, not the default 2·pp = 4: the 1F1B ring (depth 4) wraps.
    "1f1b_microbatches": dict(KW, mesh_spec="pp=2", pp_schedule="1f1b", pp_microbatches=8),
    "moe": dict(KW, mesh_spec="pp=2", pp_schedule="1f1b", n_experts=4),
    "adafactor": dict(KW, mesh_spec="pp=2", pp_schedule="1f1b", optimizer="adafactor", lr=1e-2),
    "bf16": dict(KW, mesh_spec="pp=2", pp_schedule="1f1b", param_dtype="bfloat16"),
}
# The worlds that must refuse a step of five layers for their four-layer model.
EXTRA_LAYER = ("fsdp=2", "pp=2")
REFUSED = {
    "grad_accum": (dict(KW, mesh_spec="pp=2", grad_accum=2), ValueError, "grad_accum does not compose"),
    "1f1b_without_pp": (dict(KW, mesh_spec="fsdp=2", pp_schedule="1f1b"), ValueError, "no pp axis"),
    "ring": (dict(KW, mesh_spec="pp=2", attn_impl="ring"), ValueError,
             "attn_impl='ring' cannot run inside the pp pipeline"),
    "ulysses": (dict(KW, mesh_spec="pp=2", attn_impl="ulysses"), ValueError,
                "attn_impl='ulysses' cannot run inside the pp pipeline"),
    "aux": (dict(KW, mesh_spec="pp=2", n_experts=4, moe_aux_weight=1e-2), ValueError,
            "moe_aux_weight is not supported on a pp mesh"),
    "layers": (dict(KW, mesh_spec="pp=2", n_layers=3), ValueError, "n_layers=3 not divisible by pp=2"),
    # Beside tp and ep (which run since pp composes with them,
    # tests/test_torch_pp_tp_train.py and test_torch_pp_ep_sp_train.py),
    # JAX's refusals stay: in the world of four ranks.
    "tp": (dict(KW, mesh_spec="pp=2,tp=2", n_layers=3), ValueError, "n_layers=3 not divisible by pp=2"),
    "ep": (dict(KW, mesh_spec="pp=2,ep=2", n_experts=4, moe_aux_weight=1e-2), ValueError,
           "moe_aux_weight is not supported on a pp mesh"),
}
REFUSED_FOUR = ("tp", "ep")

_JAX_RUNS = """
import os, pickle, sys
import tests.jaxenv
import jax
from pytorch_operator_tpu.checkpoint import CheckpointManager
from pytorch_operator_tpu.workloads import llama_train, trainer
cases, out_dir, n = pickle.load(open(sys.argv[1], "rb")), sys.argv[2], int(sys.argv[3])
assert jax.device_count() == n, jax.devices()
losses = []
make = trainer.make_lm_train_step

def recording(*a, **kw):
    step = make(*a, **kw)

    def run(state, tokens):
        state, loss = step(state, tokens)
        losses.append(float(jax.device_get(loss)))
        return state, loss

    return run

trainer.make_lm_train_step = recording
out = {}
for name, kw in cases.items():
    losses.clear()
    ck = os.path.join(out_dir, "ck_" + name)
    os.environ["TPUJOB_CHECKPOINT_DIR"] = ck
    r = llama_train.run(log=lambda m: None, checkpoint_every=1000, **kw)
    _, params = CheckpointManager(ck, create=False).restore_subtree("params")
    r["losses"] = list(losses)
    out[name] = {"result": r, "params": jax.tree.map(lambda a: a.astype("float32"), params)}
pickle.dump(out, open(os.path.join(out_dir, "jax.pkl"), "wb"))
"""


def _start_jax(cases: dict, n: int, d: Path):
    d.mkdir(parents=True, exist_ok=True)
    (d / "cases.pkl").write_bytes(pickle.dumps(cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
    return subprocess.Popen([sys.executable, "-c", _JAX_RUNS, str(d / "cases.pkl"), str(d), str(n)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _init(**over):
    import flax.linen as nn
    import jax

    model = jax_llama.Llama(jax_llama.llama_tiny(n_layers=4, **over))
    params = model.init(jax.random.key(0), np.zeros((1, KW["seq_len"]), np.int32))["params"]
    return jax.device_get(nn.meta.unbox(params))


def _tokens_file(path: Path) -> str:
    from pytorch_operator_tpu_torch.data import pack_arrays

    toks = np.random.default_rng(0).integers(0, 256, (16, 16)).astype(np.int32)
    pack_arrays(path, {"tokens": toks})
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs (2 and 4 devices, both subprocesses at once), the port's
    one-process references, and the port's worlds: one of two ranks for
    every pp=2 run, the vocabulary case and the cross-layout restore, one of
    four for dp=2,pp=2 and fsdp=2,pp=2."""
    d = tmp_path_factory.mktemp("pp_runs")
    procs = {2: _start_jax(TWO, 2, d / "two"), 4: _start_jax(FOUR, 4, d / "four")}
    try:
        dense, moe = _init(), _init(n_experts=4)

        def init_for(kw):
            return moe if kw.get("n_experts") else dense

        eval_f = _tokens_file(d / "eval.bin")
        ck = {k: str(d / f"ck_{k}") for k in ("pp", "resumed", "one", "one_adamw", "extra")}
        one = {name: _one(kw, init_for(kw)) for name, kw in {**TWO, **FOUR, **PORT_ONLY}.items()}
        one["eval"] = _one(dict(KW, eval_file=eval_f, eval_batches=2), dense)
        one["long"] = _one(dict(KW, steps=5), dense)
        # One-process steps for the pp ranks to restore (adafactor, AdamW),
        # and one of a model with a layer more than theirs.
        for key, kw, init in (
            ("one", dict(KW, optimizer="adafactor", lr=1e-2), dense), ("one_adamw", KW, dense),
            ("extra", dict(KW, n_layers=5), None),
        ):
            os.environ["TPUJOB_CHECKPOINT_DIR"] = ck[key]
            try:
                one["saved" if key == "one" else key] = _one(dict(kw, checkpoint_every=1000), init)
            finally:
                del os.environ["TPUJOB_CHECKPOINT_DIR"]
        train = [dict(kw, init_params=init_for(kw)) for kw in (*TWO.values(), *PORT_ONLY.values())]
        train.append(dict(KW, mesh_spec="pp=2", init_params=dense, eval_file=eval_f, eval_batches=2))
        saving = dict(KW, mesh_spec="pp=2", pp_schedule="1f1b", init_params=dense, checkpoint_every=1000)
        # Saves step 3; then, twice in one directory: steps 1-3, steps 4-6.
        train += [dict(saving, env={"TPUJOB_CHECKPOINT_DIR": d}) for d in (ck["pp"], ck["resumed"], ck["resumed"])]
        train.append(dict(KW, mesh_spec="pp=2", pp_schedule="1f1b", init_params=dense,
                          plant="pp_shifted_cotangent", env={"TPUJOB_CHECKPOINT_DIR": ""}))
        train += [dict(kw, raises=err) for name, (kw, err, _) in REFUSED.items() if name not in REFUSED_FOUR]
        two = torch_worlds.run_world("many", [
            ("train", (train,)),
            ("pp_vocab", (255, 3, 4)),
            ("restore_layout", (ck["one"], 3, "pp=2", "adafactor", {"n_layers": 4})),
            ("restore_layout", (ck["one_adamw"], 3, "pp=2", "adamw", {"n_layers": 4})),
            ("restore_layout", (ck["pp"], 3, "fsdp=2", "adamw", {"n_layers": 4})),
            *[("restore_refused", (ck["extra"], 3, spec, {"n_layers": 4})) for spec in EXTRA_LAYER],
        ], n=2, timeout=300)
        four = torch_worlds.run_world("train", [dict(kw, init_params=dense) for kw in FOUR.values()] + [
            dict(REFUSED[name][0], raises=REFUSED[name][1]) for name in REFUSED_FOUR], n=4, timeout=300)
        jax_runs = {**torch_worlds.finish_jax_runs(procs[2], d / "two"),
                    **torch_worlds.finish_jax_runs(procs[4], d / "four")}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    names = [*TWO, *PORT_ONLY, "eval", "saved", "resumed", "resume", "fault",
             *(name for name in REFUSED if name not in REFUSED_FOUR)]
    ranks = {name: [r[0][i] for r in two] for i, name in enumerate(names)}
    ranks.update({name: [r[i] for r in four] for i, name in enumerate([*FOUR, *REFUSED_FOUR])})
    ranks["vocab"] = [r[1] for r in two]
    ranks["restored"] = [r[2] for r in two]
    ranks["restored_adamw"] = [r[3] for r in two]
    ranks["fsdp_from_pp"] = [r[4] for r in two]
    for i, spec in enumerate(EXTRA_LAYER):
        ranks[f"extra_{spec}"] = [r[5 + i] for r in two]
    return {"jax": jax_runs, "one": one, "ranks": ranks, "ck": ck}


_ONE = {}


def _one(kw, init):
    """One process's run of ``kw`` without its mesh and pipeline keys (runs
    that differ only in those share it)."""
    kw = {k: v for k, v in kw.items() if not k.startswith("pp_") and k != "mesh_spec"}
    key = repr(sorted(kw.items()))
    if key not in _ONE:
        r = llama_train.run(device="cpu", init_params=init, log=lambda m: None, keep_params=True, **kw)
        r["params"] = {k: v.float().numpy() for k, v in r["params"].items()}
        _ONE[key] = r
    return _ONE[key]


def _jax_params(tree) -> dict:
    cfg = port_llama.llama_tiny(n_layers=4)
    return {k: v.numpy() for k, v in params_from_jax(tree, cfg).items()}


@pytest.mark.parametrize("case", sorted({**TWO, **FOUR}))
def test_pp_world_matches_jax_run_on_the_same_mesh(case, runs):
    """Every step's loss and the final parameters as JAX's run on the same
    mesh, on every rank."""
    kw = {**TWO, **FOUR}[case]
    want, ranks = runs["jax"][case], runs["ranks"][case]
    n = 2 if case in TWO else 4
    got = ranks[0]
    assert got["end_step"] == want["result"]["end_step"] == 3
    assert got["world"] == want["result"]["devices"] == n and got["backend"] == "gloo"
    assert got["mesh"] == llama_train.resolve_train_mesh(kw["mesh_spec"], n)
    assert set(want["result"]) <= set(got), set(want["result"]) - set(got)
    assert len(want["result"]["losses"]) == 3
    np.testing.assert_allclose(got["losses"], want["result"]["losses"], rtol=LOSS_RTOL)
    jax_sd = _jax_params(want["params"])
    for r in ranks:
        assert r["losses"] == got["losses"]
        assert r["params"].keys() == jax_sd.keys()
        for name, p in r["params"].items():
            np.testing.assert_allclose(p, jax_sd[name], atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted({**TWO, **FOUR, **PORT_ONLY}))
def test_pp_world_matches_one_process_step_for_step(case, runs):
    """Every step's loss as one process's on the same global batch (bf16
    parameters within BF16_ATOL nats), and the stages' gathered
    parameters."""
    got, one = runs["ranks"][case][0], runs["one"][case]
    if case == "bf16":
        np.testing.assert_allclose(got["losses"], one["losses"], atol=BF16_ATOL, rtol=0)
        return
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    atol = PARAM_ATOL if case != "adafactor" else 1e-4
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, one["params"][name], atol=atol, rtol=0, err_msg=name)


def test_pp_ranks_hold_their_stage(runs):
    """Rank 0 holds the embedding, each rank its 2 layers, half the head
    and the final norm; the result names the stage of each rank and the
    schedule."""
    r = runs["ranks"]["1f1b_dense"][0]
    assert [(q["data_index"], q["pp_index"]) for q in r["per_rank"]] == [(0, 0), (0, 1)]
    assert (r["pp_schedule"], r["pp_microbatches"]) == ("1f1b", 4)
    model = port_llama.Llama(port_llama.llama_tiny(n_layers=4), device="meta")
    sizes = {n: 4 * p.numel() for n, p in model.named_parameters()}
    layer = sum(v for n, v in sizes.items() if n.startswith("layers.0."))
    tail = sizes["final_norm.weight"] + sizes["lm_head.weight"] // 2
    assert [q["param_bytes"] for q in r["per_rank"]] == [sizes["embed.weight"] + 2 * layer + tail,
                                                          2 * layer + tail]
    four = runs["ranks"]["fsdp_pp"][0]["per_rank"]
    assert [(q["data_index"], q["pp_index"]) for q in four] == [(0, 0), (1, 0), (0, 1), (1, 1)]


def test_eval_on_a_pp_mesh_matches_one_process(runs):
    got, one = runs["ranks"]["eval"][0], runs["one"]["eval"]
    np.testing.assert_allclose([got["final_loss"], got["eval_loss"]], [one["final_loss"], one["eval_loss"]],
                               rtol=1e-4)
    assert got["eval_loss"] == runs["ranks"]["eval"][1]["eval_loss"]


def test_a_vocab_that_pp_does_not_divide_runs_the_tail_on_the_last_stage(runs):
    """255 over pp=2: JAX's warning, the whole head on the last stage, and
    the losses and parameters of one process's 1F1B-equal steps."""
    import torch

    from pytorch_operator_tpu_torch.workloads import trainer
    from pytorch_operator_tpu_torch.workloads.llama_train import synthetic_bigram_batch

    ranks = runs["ranks"]["vocab"]
    assert [r["head"] for r in ranks] == [None, (255, 64)]
    assert any("vocab_size=255 does not divide pp=2" in w and "cannot be vocab-parallel" in w
               for w in ranks[0]["warnings"])
    model = port_llama.Llama(port_llama.llama_tiny(vocab_size=255))
    model.init_weights(torch.Generator().manual_seed(0))
    step = trainer.make_lm_train_step(model, trainer.make_optimizer(model, 1e-3))
    losses = [float(step(torch.from_numpy(synthetic_bigram_batch(8, 16, 255, i)).long())) for i in range(3)]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(r["params"][name], p.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_pp_checkpoint_restores_whole_in_one_process(runs):
    """The pp=2 world's step (each rank its own layers and head rows)
    restored by one process equals the world's gathered parameters bit for
    bit."""
    got = runs["ranks"]["saved"][0]
    restored = CheckpointManager(runs["ck"]["pp"], create=False).restore({"params": None}, step=3)["params"]
    assert restored.keys() == got["params"].keys()
    for name, p in got["params"].items():
        np.testing.assert_array_equal(restored[name].numpy(), p, err_msg=name)


def test_pp_world_resumes_from_its_own_step_bit_for_bit(runs):
    """A pp world that resumes from its step 3 (AdamW's moments keyed by
    each parameter's index in the whole model) trains steps 4-6 as the
    uninterrupted six-step run."""
    resumed, straight = runs["ranks"]["resume"][0], runs["one"]["long"]
    assert resumed["end_step"] == 6 and len(resumed["losses"]) == 3
    np.testing.assert_allclose(resumed["losses"], straight["losses"][3:], rtol=LOSS_RTOL)
    for name, p in resumed["params"].items():
        np.testing.assert_allclose(p, straight["params"][name], atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_pp_ranks_restore_a_one_process_step_reading_only_their_tensors(runs):
    """Each pp rank restores from one process's step its own tensors (its
    layers, stage 0's embedding, its head rows) and adafactor's statistics
    of them, bit for bit, and reads only those elements."""
    import torch

    _, whole = CheckpointManager(runs["ck"]["one"], create=False).restore_subtree("params")
    opt = CheckpointManager(runs["ck"]["one"], create=False).restore({"opt_state": None})["opt_state"]
    n_whole = sum(t.numel() for t in whole.values()) + sum(
        t.numel() for st in opt["adafactor"].values() for t in st.values())
    for r in runs["ranks"]["restored"]:
        held = 0
        for name, b in r["params"].items():
            box = tuple(slice(o, o + s) for o, s in zip(b["offsets"], b["data"].shape))
            np.testing.assert_array_equal(b["data"], whole[name].numpy()[box], err_msg=name)
            held += b["data"].size
        for path, st in r["opt"]["adafactor"].items():
            for k, b in st.items():
                box = tuple(slice(o, o + s) for o, s in zip(b["offsets"], b["data"].shape))
                want = opt["adafactor"][path][k].to(torch.float32).numpy()
                np.testing.assert_array_equal(b["data"], want[box], err_msg=f"{path}/{k}")
                held += b["data"].size
        assert r["read"] == held and held < 0.75 * n_whole, (r["read"], held, n_whole)


def _box(b):
    return tuple(slice(o, o + s) for o, s in zip(b["offsets"], b["data"].shape))


def test_pp_ranks_restore_a_one_process_adamw_step_reading_only_their_tensors(runs):
    """Each pp rank restores from one process's AdamW step its own tensors
    and their moments (keyed by the parameter's index in the whole model),
    bit for bit, and reads only those elements."""
    import torch

    mgr = CheckpointManager(runs["ck"]["one_adamw"], create=False)
    _, whole = mgr.restore_subtree("params")
    opt = mgr.restore({"opt_state": None})["opt_state"]
    state = opt["adamw"]["state"]
    n_whole = sum(t.numel() for t in whole.values()) + sum(
        t.numel() for st in state.values() for k, t in st.items() if k != "step")
    names = list(whole)
    for r in runs["ranks"]["restored_adamw"]:
        held = 0
        for name, b in r["params"].items():
            np.testing.assert_array_equal(b["data"], whole[name].numpy()[_box(b)], err_msg=name)
            held += b["data"].size
        assert r["opt"]["count"] == opt["count"]
        mine = r["opt"]["adamw"]["state"]
        assert sorted(mine) == sorted(names.index(n) for n in r["params"]), sorted(mine)
        for key, st in mine.items():
            for k in ("exp_avg", "exp_avg_sq"):
                want = state[key][k].to(torch.float32).numpy()
                np.testing.assert_array_equal(st[k]["data"], want[_box(st[k])], err_msg=f"{key}/{k}")
                held += st[k]["data"].size
            assert float(st["step"]) == float(state[key]["step"])
        assert r["read"] == held and held < 0.75 * n_whole, (r["read"], held, n_whole)


def test_an_fsdp_world_restores_a_pp_adamw_step(runs):
    """The pp=2 world's step 3 restored by an fsdp=2 world: each rank's rows
    of the parameters and of AdamW's moments as the step's whole tensors
    (the pp world's gathered parameters; the moments as one process restores
    them)."""
    import torch

    params = runs["ranks"]["saved"][0]["params"]
    opt = CheckpointManager(runs["ck"]["pp"], create=False).restore({"opt_state": None})["opt_state"]
    state = opt["adamw"]["state"]
    names = list(params)
    assert sorted(state) == list(range(len(names)))
    for r in runs["ranks"]["fsdp_from_pp"]:
        assert r["params"].keys() == params.keys()
        for name, b in r["params"].items():
            np.testing.assert_array_equal(b["data"], params[name][_box(b)], err_msg=name)
        for key, st in r["opt"]["adamw"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                want = state[key][k].to(torch.float32).numpy()
                np.testing.assert_array_equal(st[k]["data"], want[_box(st[k])],
                                              err_msg=f"{names[key]}/{k}")


@pytest.mark.parametrize("spec", EXTRA_LAYER)
def test_a_step_with_an_extra_layer_is_refused(spec, runs):
    """A five-layer step restored into a four-layer model's fsdp=2 or pp=2
    world raises ValueError on every rank, naming the layer the model
    lacks: a pp stage holds its part to the whole model's names."""
    msgs = runs["ranks"][f"extra_{spec}"]
    assert all("layers.4." in m and "expected nothing" in m for m in msgs), msgs


def test_a_planted_pipeline_fault_reads_far_above_the_tolerance(runs):
    """Each stage backwarding a microbatch's graph with the previous
    microbatch's cotangent: the first loss as one process's, the later ones
    over 100x the tolerance away (the chip's phase 15(c) plants the same)."""
    got, one = runs["ranks"]["fault"][0]["losses"], runs["one"]["1f1b_dense"]["losses"]
    assert got[0] == pytest.approx(one[0], rel=LOSS_RTOL)
    assert max(abs(a - b) / b for a, b in zip(got, one)) > 100 * LOSS_RTOL, (got, one)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_pp_refusals_name_their_reason(case, runs):
    _, _, pattern = REFUSED[case]
    assert all(pattern in m for m in runs["ranks"][case]), runs["ranks"][case]
