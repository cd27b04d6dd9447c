"""Pipeline stages beside tensor parallelism in the port's
``llama_train.run``: ``pp=2,tp=2`` (four ranks), each stage's layers tp's
blocks, the head's vocabulary rows cut by pp and then by tp inside each stage
(stage s, tp rank t at ``s·V/P + t·V/(P·tp)``), the loss tail vocab-parallel
over both. The tiny Llama at 4 layers with dense attention, B8 × 16, from
JAX's key-0 init carried by ``params_from_jax``.

Against the JAX package's ``llama_train.run`` on the same mesh over four
virtual CPU devices: GPipe with the dense loss, 1F1B with the chunked one,
the MoE Llama (4 experts, each a tp block) and adafactor, every step's loss within
rtol 2e-5 and the final parameters within atol 3e-5
(``tests/test_torch_pp_train.py``'s tolerances). Against the port's one
process, every loss within rtol 1e-5 (and the parameters): those runs,
GPipe with the chunked loss and 1F1B with the dense one, remat;
and two vocabularies whose stage rows tp does not divide (254 and 250: tp
then holds a stage's rows whole), whose losses are also held against JAX's
pipeline at the model level (``tests/test_llama_pp.py``'s ``_train`` on
the same mesh, tokens drawn inside the vocabulary), and whose first step's
gradients, gathered whole, are held against one process's (relative L2
1e-5 a parameter).

Layout: each rank's head rows as loaded are its nested slice of JAX's
``lm_head.kernel``; the world's checkpoint restored whole by one process
bit for bit; one process's AdamW step restored by the world, each rank
reading only its own blocks; and a planted fault (each rank's blocks taken
tp outer, pp inner, while the loss's column offset stays pp-outer) off
JAX's parameters and losses.
"""

import os

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from pytorch_operator_tpu_torch.checkpoint import CheckpointManager
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.workloads import llama_train
from tests import torch_worlds

KW = dict(config="tiny", n_layers=4, batch_size=8, seq_len=16, steps=2, warmup=1, lr=1e-3,
          attn_impl="dense", mesh_spec="pp=2,tp=2")
LOSS_RTOL, PARAM_ATOL, ONE_RTOL = 2e-5, 3e-5, 1e-5
# The first step's gradients against one process's, relative L2 a
# parameter.
GRAD_RTOL = 1e-5
# Against JAX's run on the same mesh (and against one process): both
# schedules and both losses, and the MoE Llama's experts as tp blocks.
JAX_CASES = {
    "gpipe_dense": dict(KW, pp_schedule="gpipe", xent_impl="dense"),
    "1f1b_chunked": dict(KW, pp_schedule="1f1b", xent_impl="chunked"),
    "moe": dict(KW, pp_schedule="1f1b", n_experts=4),
    "adafactor": dict(KW, pp_schedule="1f1b", optimizer="adafactor", lr=1e-2),
}
# Against one process only (each JAX run costs the tier-1 clock ~20 s).
PORT_ONLY = {
    "gpipe_chunked": dict(KW, pp_schedule="gpipe", xent_impl="chunked"),
    "1f1b_dense": dict(KW, pp_schedule="1f1b", xent_impl="dense"),
    "1f1b_remat": dict(KW, pp_schedule="1f1b", remat=True),
}
# Vocabularies whose stage rows (V/2) tp=2 does not divide, against one
# process and JAX's model-level pipeline; 256 for the nested head rows.
VOCABS = (254, 250)
_TOKENS = np.random.default_rng(0).integers(0, 1 << 16, (8, 16))


def _tokens(vocab: int) -> np.ndarray:
    return (_TOKENS % vocab).astype(np.int32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs on four virtual devices (a subprocess), the port's
    one-process references, and one four-rank world for every port run."""
    d = tmp_path_factory.mktemp("pp_tp_runs")
    model_cases = {f"vocab_{v}": dict(model={"vocab_size": v}, mesh="pp=2,tp=2", tokens=_tokens(v),
                                      steps=3, schedule="1f1b") for v in VOCABS}
    proc = torch_worlds.start_jax_recorded({**JAX_CASES, **model_cases}, 4, d / "jax")
    try:
        init, moe = torch_worlds.jax_init(), torch_worlds.jax_init(n_experts=4)

        def init_for(kw):
            return moe if kw.get("n_experts") else init

        vocab_init = {v: torch_worlds.jax_init(vocab_size=v) for v in (256, *VOCABS)}
        one = {name: _one(kw, init_for(kw)) for name, kw in {**JAX_CASES, **PORT_ONLY}.items()}
        one.update({f"vocab_{v}": _one_model(vocab_init[v], v) for v in VOCABS})
        ck = {k: str(d / f"ck_{k}") for k in ("world", "one")}
        os.environ["TPUJOB_CHECKPOINT_DIR"] = ck["one"]
        try:
            _one(dict(KW, checkpoint_every=1000), init)
        finally:
            del os.environ["TPUJOB_CHECKPOINT_DIR"]
        train = [dict(kw, init_params=init_for(kw)) for kw in (*JAX_CASES.values(), *PORT_ONLY.values())]
        train.append(dict(JAX_CASES["gpipe_dense"], init_params=init, checkpoint_every=1000,
                          env={"TPUJOB_CHECKPOINT_DIR": ck["world"]}))
        train.append(dict(JAX_CASES["gpipe_dense"], init_params=init, plant="pp_tp_outer_head",
                          env={"TPUJOB_CHECKPOINT_DIR": ""}))
        world = torch_worlds.run_world("many", [
            ("train", (train,)),
            *[("pp_model", (vocab_init[v], {"vocab_size": v}, "pp=2,tp=2", _tokens(v), 3, "1f1b"))
              for v in VOCABS],
            ("pp_model", (vocab_init[256], {}, "pp=2,tp=2", _tokens(256), 0, "1f1b")),
            ("restore_layout", (ck["one"], 3, "pp=2,tp=2", "adamw", {"n_layers": 4})),
        ], n=4, timeout=400)
        jax_runs = torch_worlds.finish_jax_runs(proc, d / "jax")
    finally:
        if proc.poll() is None:
            proc.kill()
    names = [*JAX_CASES, *PORT_ONLY, "saved", "fault"]
    ranks = {name: [r[0][i] for r in world] for i, name in enumerate(names)}
    for i, v in enumerate(VOCABS):
        ranks[f"vocab_{v}"] = [r[1 + i] for r in world]
    ranks["heads"] = [r[1 + len(VOCABS)] for r in world]
    ranks["restored"] = [r[2 + len(VOCABS)] for r in world]
    return {"jax": jax_runs, "one": one, "ranks": ranks, "ck": ck, "init": vocab_init}


_ONE = {}


def _one(kw, init):
    """One process's run of ``kw`` without its mesh and pipeline keys."""
    kw = {k: v for k, v in kw.items() if not k.startswith("pp_") and k != "mesh_spec"}
    key = repr(sorted(kw.items()))
    if key not in _ONE:
        r = llama_train.run(device="cpu", init_params=init, log=lambda m: None, keep_params=True, **kw)
        r["params"] = {k: v.float().numpy() for k, v in r["params"].items()}
        _ONE[key] = r
    return _ONE[key]


def _one_model(tree, vocab: int) -> dict:
    """:func:`torch_worlds.rank_pp_model`'s steps in one process: the
    losses and the first step's gradients."""
    import torch

    from pytorch_operator_tpu_torch.workloads import trainer

    cfg = port_llama.llama_tiny(n_layers=4, attn_impl="dense", vocab_size=vocab)
    model = port_llama.Llama(cfg)
    model.load_state_dict(params_from_jax(tree, cfg))
    opt = trainer.make_optimizer(model, 1e-3, weight_decay=1e-4)
    grads = torch_worlds.first_step_grads(model, opt, lambda: {n: p.grad for n, p in model.named_parameters()})
    step = trainer.make_lm_train_step(model, opt)
    tokens = torch.from_numpy(_tokens(vocab)).long()
    return {"losses": [float(step(tokens)) for _ in range(3)], "grads": grads}


def _jax_params(tree, n_experts: int = 0) -> dict:
    cfg = port_llama.llama_tiny(n_layers=4, n_experts=n_experts)
    return {k: v.numpy() for k, v in params_from_jax(tree, cfg).items()}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_pp_tp_world_matches_jax_run_on_the_same_mesh(case, runs):
    """Every step's loss and the final parameters as JAX's run on the same
    mesh, on every rank."""
    want, ranks = runs["jax"][case], runs["ranks"][case]
    got = ranks[0]
    assert got["end_step"] == want["result"]["end_step"] == 3
    assert got["world"] == want["result"]["devices"] == 4 and got["backend"] == "gloo"
    assert got["mesh"] == {"pp": 2, "tp": 2}
    assert set(want["result"]) <= set(got), set(want["result"]) - set(got)
    assert len(want["result"]["losses"]) == 3
    np.testing.assert_allclose(got["losses"], want["result"]["losses"], rtol=LOSS_RTOL)
    jax_sd = _jax_params(want["params"], n_experts=4 if "n_experts" in JAX_CASES[case] else 0)
    for r in ranks:
        assert r["losses"] == got["losses"]
        assert r["params"].keys() == jax_sd.keys()
        for name, p in r["params"].items():
            np.testing.assert_allclose(p, jax_sd[name], atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted({**JAX_CASES, **PORT_ONLY}))
def test_pp_tp_world_matches_one_process_step_for_step(case, runs):
    """Every step's loss as one process's on the same global batch, and the
    ranks' gathered parameters."""
    got, one = runs["ranks"][case][0], runs["one"][case]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=ONE_RTOL)
    atol = PARAM_ATOL if case != "adafactor" else 1e-4
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, one["params"][name], atol=atol, rtol=0, err_msg=name)


def test_pp_tp_ranks_hold_their_blocks(runs):
    """Each rank's coordinates and parameter bytes: stage 0 half the
    embedding, every rank its stage's 2 layers as tp blocks (the norms
    whole), the final norm and a quarter of the head."""
    r = runs["ranks"]["1f1b_chunked"][0]
    assert [(q["data_index"], q["pp_index"], q["tp_index"]) for q in r["per_rank"]] == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    assert (r["pp_schedule"], r["pp_microbatches"]) == ("1f1b", 4)
    model = port_llama.Llama(port_llama.llama_tiny(n_layers=4), device="meta")
    sizes = {n: 4 * p.numel() for n, p in model.named_parameters()}
    layer = sum(v // (1 if n.endswith("norm.weight") else 2) for n, v in sizes.items()
                if n.startswith("layers.0."))
    tail = sizes["final_norm.weight"] + sizes["lm_head.weight"] // 4
    want = [sizes["embed.weight"] // 2 + 2 * layer + tail] * 2 + [2 * layer + tail] * 2
    assert [q["param_bytes"] for q in r["per_rank"]] == want


@pytest.mark.parametrize("vocab", (256, *VOCABS))
def test_each_rank_holds_its_nested_slice_of_the_jax_head(vocab, runs):
    """The head rows each rank loads are JAX's ``lm_head.kernel`` columns
    ``[s·V/P + t·V/(P·tp), ...)`` (pp outer, tp inner), and its loss's
    column offset is their first id; where tp does not divide a stage's
    V/2 rows, the stage's tp ranks hold them whole."""
    kernel = runs["init"][vocab]["lm_head"]["kernel"]
    ranks = runs["ranks"]["heads" if vocab == 256 else f"vocab_{vocab}"]
    split = (vocab // 2) % 2 == 0
    n = vocab // 4 if split else vocab // 2
    for r in ranks:
        start = r["pp_index"] * (vocab // 2) + (r["tp_index"] * n if split else 0)
        assert r["head_offset"] == start
        np.testing.assert_array_equal(r["head"], kernel[:, start:start + n])


@pytest.mark.parametrize("vocab", VOCABS)
def test_a_stage_whose_rows_tp_does_not_divide_trains_as_one_process_and_jax(vocab, runs):
    """254 and 250 at pp=2,tp=2 (JAX runs them; only a tp that does not
    divide V is refused): every rank's losses as one process's steps and
    JAX's model-level pipeline's on the same mesh, tokens drawn inside the
    vocabulary (finite, falling)."""
    one, jax_losses = runs["one"][f"vocab_{vocab}"], runs["jax"][f"vocab_{vocab}"]["losses"]
    assert len(jax_losses) == 3 and np.isfinite(one["losses"]).all()
    assert one["losses"][-1] < one["losses"][0]
    for r in runs["ranks"][f"vocab_{vocab}"]:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=ONE_RTOL)
        np.testing.assert_allclose(r["losses"], jax_losses, rtol=LOSS_RTOL)


@pytest.mark.parametrize("vocab", VOCABS)
def test_a_stage_whose_rows_tp_does_not_divide_has_one_process_first_gradients(vocab, runs):
    """At 254 and 250 every rank's first-step gradients, gathered whole
    from the ranks' blocks, are one process's: relative L2 within
    ``GRAD_RTOL`` for each parameter (AdamW's later steps amplify f32 noise
    in the parameters, so the gradients say whether one is doubled or
    lost)."""
    want = runs["one"][f"vocab_{vocab}"]["grads"]
    for r in runs["ranks"][f"vocab_{vocab}"]:
        assert r["grads"].keys() == want.keys()
        for name, g in r["grads"].items():
            gap = np.linalg.norm(g - want[name]) / np.linalg.norm(want[name])
            assert gap <= GRAD_RTOL, (name, gap)


def test_pp_tp_checkpoint_restores_whole_in_one_process(runs):
    """The pp=2,tp=2 world's step 3 (each rank its blocks of its stage)
    restored by one process equals the world's gathered parameters bit for
    bit."""
    got = runs["ranks"]["saved"][0]
    restored = CheckpointManager(runs["ck"]["world"], create=False).restore({"params": None}, step=3)["params"]
    assert restored.keys() == got["params"].keys()
    for name, p in got["params"].items():
        np.testing.assert_array_equal(restored[name].numpy(), p, err_msg=name)


def _box(b):
    return tuple(slice(o, o + s) for o, s in zip(b["offsets"], b["data"].shape))


def test_pp_tp_ranks_restore_a_one_process_step_reading_only_their_blocks(runs):
    """Each rank restores from one process's AdamW step its blocks of its
    stage's tensors and their moments, bit for bit, and reads only those
    elements."""
    import torch

    mgr = CheckpointManager(runs["ck"]["one"], create=False)
    _, whole = mgr.restore_subtree("params")
    state = mgr.restore({"opt_state": None})["opt_state"]["adamw"]["state"]
    names = list(whole)
    n_whole = sum(t.numel() for t in whole.values()) + sum(
        t.numel() for st in state.values() for k, t in st.items() if k != "step")
    heads = set()
    for r in runs["ranks"]["restored"]:
        held = 0
        for name, b in r["params"].items():
            np.testing.assert_array_equal(b["data"], whole[name].numpy()[_box(b)], err_msg=name)
            held += b["data"].size
        heads.add(r["params"]["lm_head.weight"]["offsets"])
        for key, st in r["opt"]["adamw"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                want = state[key][k].to(torch.float32).numpy()
                np.testing.assert_array_equal(st[k]["data"], want[_box(st[k])], err_msg=f"{names[key]}/{k}")
                held += st[k]["data"].size
        assert r["read"] == held and held < 0.5 * n_whole, (r["read"], held, n_whole)
    assert heads == {(0, 0), (64, 0), (128, 0), (192, 0)}


def test_a_planted_head_nesting_fault_breaks_the_run(runs):
    """Rows of the tp-outer nesting under the loss's pp-outer offsets: the
    losses leave JAX's by far more than the tolerance and the gathered head
    JAX's parameters beyond ``PARAM_ATOL``."""
    got = runs["ranks"]["fault"][0]
    want = runs["jax"]["gpipe_dense"]
    gaps = [abs(a - b) / b for a, b in zip(got["losses"], want["result"]["losses"])]
    assert max(gaps) > 100 * LOSS_RTOL, gaps
    jax_sd = _jax_params(want["params"])
    assert np.abs(got["params"]["lm_head.weight"] - jax_sd["lm_head.weight"]).max() > PARAM_ATOL
