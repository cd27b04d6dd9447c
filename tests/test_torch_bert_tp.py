"""BERT over every mesh JAX's ``bert_fsdp`` takes, on the CPU, at
``bert_tiny`` in f32: tp as tensor parallelism (the heads, ``d_ff`` and the
vocabulary split, the rest whole), sp, ep and pp as replicas.

- Against the JAX package's ``bert_fsdp.run`` on the same mesh over four
  virtual CPU devices (one subprocess, every step's loss recorded around
  its train step and the final parameters taken from the state its step
  loop returns): fsdp=2,tp=2, dp=2,tp=2, tp=4, fsdp=2,sp=2, ep=2,fsdp=2,
  pp=2,fsdp=2 and fsdp=2,tp=2 with ``grad_clip``, all run in sequence in
  one four-rank gloo world from JAX's key-0 init. Every step's loss within
  ``RUN_LOSS_RTOL``, the final parameters gathered whole
  (``sharding.full_state_dict``) within ``PARAM_ATOL``, and every rank's
  gathered parameters equal bit for bit (the tensors tp holds whole, and
  sp's, ep's and pp's replicas).
- Against one JAX process: ``BertClassifier`` and ``BertMLM`` at tp=2
  (dp=2,tp=2 in the same world) on JAX's weights with every bias drawn
  non-zero: the sequence output and the logits within ``F32_ATOL``, every
  gathered gradient within ``F32_GRAD_RTOL`` (relative L2), with a pad mask
  and with ``type_ids``.
- Layout: each rank's blocks (``bert_params_from_jax(tree, tp=...)``, and
  the seeded init of a tp model) equal its slice of JAX's leaves and of the
  one-process init; ``pos_embed``, ``type_embed``, the LayerNorms, the
  pooler, the classifier and the row-parallel biases whole on every rank;
  the tables looked up by whole names.
- Planted faults, each read above its limit: the row-parallel bias added
  on every tp rank (the logits, at the module level), ``pos_embed`` split
  by the Llama's suffix (the run's losses and parameters at fsdp=2,tp=2).

Limits are ``tests/test_torch_bert.py``'s (``F32_ATOL``, ``F32_GRAD_RTOL``,
``RUN_LOSS_RTOL``) and ``tests/test_torch_pp_train.py``'s ``PARAM_ATOL``.
"""

import functools

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import flax.linen as nn
import jax
import jax.numpy as jnp
import optax
import torch

from pytorch_operator_tpu.models import bert as jax_bert
from pytorch_operator_tpu_torch.models import bert as port_bert
from pytorch_operator_tpu_torch.models.convert import bert_params_from_jax
from pytorch_operator_tpu_torch.parallel import sharding
from pytorch_operator_tpu_torch.parallel.sharding import TensorParallel
from tests import torch_worlds
from tests.test_torch_bert import CASES, CLASSES, F32_ATOL, F32_GRAD_RTOL, RUN_LOSS_RTOL, _inputs

PARAM_ATOL = 3e-5
RUN = dict(batch_size=8, seq_len=16, steps=2, warmup=1, lr=3e-4)
# The meshes of JAX's bert_fsdp over four devices, and the clip on one.
MESH_CASES = {
    "fsdp2_tp2": dict(RUN, mesh_spec="fsdp=2,tp=2"),
    "dp2_tp2": dict(RUN, mesh_spec="dp=2,tp=2"),
    "tp4": dict(RUN, mesh_spec="tp=4"),
    "fsdp2_sp2": dict(RUN, mesh_spec="fsdp=2,sp=2"),
    "ep2_fsdp2": dict(RUN, mesh_spec="ep=2,fsdp=2"),
    "pp2_fsdp2": dict(RUN, mesh_spec="pp=2,fsdp=2"),
    "fsdp2_tp2_clip": dict(RUN, mesh_spec="fsdp=2,tp=2", grad_clip=0.05),
}
# The module-level cases at tp=2: the classifier with and without a pad
# mask and type_ids, the MLM with both.
MODULE_CASES = {**{f"classifier_{c}": ("classifier", c) for c in CASES},
                "mlm_type_ids_pad_mask": ("mlm", "type_ids_pad_mask")}
# Some of the tensors tp holds whole (JAX's (None, "embed") embeddings, the
# LayerNorms, the pooler, the classifier, the row-parallel biases).
WHOLE = ("bert.pos_embed.weight", "bert.type_embed.weight", "bert.embed_ln.weight", "bert.pooler.weight",
         "bert.pooler.bias", "classifier.weight", "classifier.bias", "bert.layers.0.attn_ln.weight",
         "bert.layers.0.mlp_ln.bias", "bert.layers.1.attn.o_proj.bias", "bert.layers.1.mlp_down.bias")


def _jax_init(head: str = "classifier", types: bool = False, biases: bool = False) -> dict:
    """JAX's key-0 init of ``bert_tiny`` (with ``type_embed`` when
    ``types``) as numpy; with ``biases`` every bias drawn from N(0, 0.1)."""
    model = (jax_bert.BertClassifier(jax_bert.bert_tiny(), num_classes=CLASSES if biases else 2)
             if head == "classifier" else jax_bert.BertMLM(jax_bert.bert_tiny()))
    toks = np.zeros((1, RUN["seq_len"]), np.int32)
    params = model.init(jax.random.key(0), toks, toks if types else None)["params"]
    params = jax.device_get(nn.meta.unbox(params))
    if not biases:
        return params
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key == "bias" else np.asarray(a), params)


def _module_case(name: str, plant=None) -> dict:
    head, case = MODULE_CASES[name]
    toks, types, pad, labels = _inputs()
    kw = CASES[case]
    return dict(head=head, tokens=toks, type_ids=types if kw["types"] else None,
                pad_mask=pad if kw["pad"] else None, labels=labels, classes=CLASSES, plant=plant)


@functools.lru_cache(maxsize=None)
def _tree(head: str) -> dict:
    """The module cases' weights: JAX's init with type_embed and every bias
    non-zero."""
    return _jax_init(head, types=True, biases=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs on four virtual devices (a subprocess, started first), and
    one four-rank world for every port run, the module cases and the
    layout of ``shard_model``."""
    d = tmp_path_factory.mktemp("bert_tp")
    proc = torch_worlds.start_jax_recorded(MESH_CASES, 4, d / "jax", script=torch_worlds.JAX_BERT_RECORDED)
    try:
        init = bert_params_from_jax(_jax_init())
        classifier = [n for n in MODULE_CASES if n.startswith("classifier")]
        calls = [
            ("bert_runs", (init, [*MESH_CASES.values(),
                                  dict(MESH_CASES["fsdp2_tp2"], plant="bert_pos_embed_by_suffix")])),
            ("bert_tp_module", (_tree("classifier"), "dp=2,tp=2", [
                *map(_module_case, classifier),
                _module_case("classifier_type_ids_pad_mask", plant="bert_bias_every_rank")])),
            ("bert_tp_module", (_tree("mlm"), "dp=2,tp=2", [_module_case("mlm_type_ids_pad_mask")])),
            ("bert_shard", ("ep=2,fsdp=2",)),
        ]
        world = torch_worlds.run_world("many", calls, n=4, timeout=400)
        jax_runs = torch_worlds.finish_jax_runs(proc, d / "jax")
    finally:
        if proc.poll() is None:
            proc.kill()
    ranks = {name: [r[0][i] for r in world] for i, name in enumerate([*MESH_CASES, "pos_fault"])}
    module = {name: [r[1][i] for r in world] for i, name in enumerate([*classifier, "bias_fault"])}
    module["mlm_type_ids_pad_mask"] = [r[2][0] for r in world]
    return {"jax": jax_runs, "ranks": ranks, "module": module, "shard": [r[3] for r in world]}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_bert_world_matches_jax_run_on_the_same_mesh(case, runs):
    """Every step's loss as JAX's run on the same mesh, and the final
    parameters gathered whole on every rank as JAX's."""
    want, ranks = runs["jax"][case], runs["ranks"][case]
    got = ranks[0]
    assert len(want["losses"]) == RUN["warmup"] + RUN["steps"] == len(got["losses"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RUN_LOSS_RTOL)
    assert got["final_loss"] == pytest.approx(want["result"]["final_loss"], abs=1e-4)
    for key in ("metric", "model", "params_m", "n_layers", "d_model", "devices"):
        assert got[key] == want["result"][key], key
    jax_sd = bert_params_from_jax(want["params"])
    assert got["params"].keys() == jax_sd.keys()
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, jax_sd[name].numpy(), atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_every_rank_holds_the_same_parameters_bit_for_bit(case, runs):
    """The ranks' gathered parameters are equal bit for bit: the copies of
    the tensors tp holds whole, and the replicas over sp, ep and pp (their
    gradients averaged after the backward); every rank's losses equal."""
    ranks = runs["ranks"][case]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for name, p in r["params"].items():
            np.testing.assert_array_equal(p, ranks[0]["params"][name], err_msg=name)


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_result_names_the_mesh_and_this_ranks_bytes(case, runs):
    """The result's mesh is the case's; a rank's parameter bytes are its
    tp blocks and whole tensors (exact without fsdp; over fsdp=2 half of
    them, give or take FSDP2's ceil-sized chunks: a row a tensor), AdamW's
    at least twice those."""
    from pytorch_operator_tpu_torch.parallel.mesh import parse_mesh_spec

    axes = parse_mesh_spec(MESH_CASES[case]["mesh_spec"])
    with torch.device("meta"):
        model = port_bert.BertClassifier(port_bert.bert_tiny(), 2)
    tp = axes.get("tp", 1)
    want = sum(4 * p.numel() // (tp if sharding.axis_dim(n, "tp", table=sharding.BERT_PARAM_AXES) is not None
                                 else 1) for n, p in model.named_parameters())
    rows = 4 * 64 * len(list(model.parameters()))
    for r in runs["ranks"][case]:
        assert (r["mesh"], r["world"], r["backend"]) == (axes, 4, "gloo")
        if "fsdp" in axes:
            assert abs(r["param_bytes"] - want / 2) <= rows, (r["param_bytes"], want)
        else:
            assert r["param_bytes"] == want
        assert r["optimizer_state_bytes"] >= 2 * r["param_bytes"]


def _jax_module(name: str):
    """JAX's sequence output, logits and gradients (as the port's state
    dict) of a module case on one device."""
    head, case = MODULE_CASES[name]
    c = _module_case(name)
    tree = _tree(head)
    cfg = jax_bert.bert_tiny()
    jm = jax_bert.BertClassifier(cfg, num_classes=CLASSES) if head == "classifier" else jax_bert.BertMLM(cfg)

    def loss_fn(p):
        logits = jm.apply({"params": p}, c["tokens"], c["type_ids"], c["pad_mask"])
        if head == "classifier":
            return optax.softmax_cross_entropy_with_integer_labels(logits, c["labels"]).mean(), logits
        return jnp.mean(logits ** 2), logits

    (_, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(tree)
    seq, _ = jax_bert.Bert(cfg).apply({"params": tree["bert"]}, c["tokens"], c["type_ids"], c["pad_mask"])
    return np.asarray(seq), np.asarray(logits), bert_params_from_jax(grads)


@pytest.mark.parametrize("name", sorted(MODULE_CASES))
def test_tp2_module_matches_jax_on_one_device(name, runs):
    """The sequence output and the logits on every rank, and every gradient
    gathered whole, as JAX's one device on the same weights (every bias
    non-zero)."""
    seq, logits, grads = _jax_module(name)
    ranks = runs["module"][name]
    assert sorted(r["tp_index"] for r in ranks) == [0, 0, 1, 1]
    for r in ranks:
        assert np.abs(r["seq"] - seq).max() <= F32_ATOL
        assert r["logits"].shape == logits.shape and np.abs(r["logits"] - logits).max() <= F32_ATOL
        assert r["grads"].keys() == grads.keys()
        for n, g in grads.items():
            g = g.numpy()
            if n.endswith("k_proj.bias"):  # zero in exact arithmetic (softmax's shift invariance)
                assert max(np.linalg.norm(r["grads"][n]), np.linalg.norm(g)) < 1e-4, n
            elif not g.any():  # the MLM's pooler
                assert not r["grads"][n].any(), n
            else:
                assert np.linalg.norm(r["grads"][n] - g) / np.linalg.norm(g) <= F32_GRAD_RTOL, n


def test_planted_row_parallel_bias_on_every_rank_reads_above_the_limit(runs):
    """o_proj's and mlp_down's whole bias added by both tp ranks before the
    sum (counted twice) moves the logits far past the limit the sound model
    holds on the same weights and inputs."""
    _, logits, _ = _jax_module("classifier_type_ids_pad_mask")
    sound = max(np.abs(r["logits"] - logits).max() for r in runs["module"]["classifier_type_ids_pad_mask"])
    fault = min(np.abs(r["logits"] - logits).max() for r in runs["module"]["bias_fault"])
    assert sound <= F32_ATOL < 100 * F32_ATOL < fault, (sound, fault)


def test_planted_pos_embed_split_by_suffix_reads_above_the_limit(runs):
    """``pos_embed`` split over tp as the Llama's ``embed.weight`` is: each
    tp rank adds other positions' rows, and the run leaves JAX's losses and
    parameters far past the limits."""
    want, got = runs["jax"]["fsdp2_tp2"], runs["ranks"]["pos_fault"][0]
    gaps = [abs(a - b) / b for a, b in zip(got["losses"], want["losses"])]
    assert max(gaps) > 100 * RUN_LOSS_RTOL, gaps
    jax_sd = bert_params_from_jax(want["params"])
    assert max(np.abs(p - jax_sd[n].numpy()).max() for n, p in got["params"].items()) > 10 * PARAM_ATOL


# The tensors tp splits: q, k and v (weight and bias) by heads, o_proj's
# input, mlp_up (weight and bias) and mlp_down's input by d_ff, the word
# embedding's and the MLM head's vocabulary rows.
SPLIT = {*(f"attn.{p}_proj.{leaf}" for p in "qkv" for leaf in ("weight", "bias")), "attn.o_proj.weight",
         "mlp_up.weight", "mlp_up.bias", "mlp_down.weight"}


@pytest.mark.parametrize("tp", [2, 4])
def test_each_rank_holds_its_slice_of_the_jax_leaves(tp):
    """``bert_params_from_jax(tree, tp)`` gives rank t rows ``[t·n/tp,
    (t+1)·n/tp)`` of q/k/v (weight and bias), ``mlp_up``, the word
    embedding and the MLM head, the matching input columns of o_proj and
    ``mlp_down``, and every other tensor whole (``pos_embed``,
    ``type_embed``, the LayerNorms, the pooler, the classifier, the
    row-parallel biases), as JAX's leaves; the tp model's parameters have
    those shapes."""
    cfg = port_bert.bert_tiny()
    for head in ("classifier", "mlm"):
        whole = bert_params_from_jax(_tree(head))
        split = {n for n in whole if n.split(".", 3)[-1] in SPLIT} | {"bert.word_embed.weight"} | (
            {"mlm_head.weight"} if head == "mlm" else set())
        assert split.isdisjoint(WHOLE) and len(split) == 1 + 10 * cfg.n_layers + (head == "mlm")
        for t in range(tp):
            ax = TensorParallel(tp, t)
            blocks = bert_params_from_jax(_tree(head), tp=ax)
            for name, w in whole.items():
                d = sharding.axis_dim(name, "tp", table=sharding.BERT_PARAM_AXES)
                assert (d is not None) == (name in split), name
                want = w if d is None else w.narrow(d, t * w.shape[d] // tp, w.shape[d] // tp)
                assert torch.equal(blocks[name], want), name
            model = (port_bert.BertClassifier(cfg, CLASSES, type_embed=True, tp=ax) if head == "classifier"
                     else port_bert.BertMLM(cfg, type_embed=True, tp=ax))
            assert {n: tuple(p.shape) for n, p in model.state_dict().items()} == {
                n: tuple(b.shape) for n, b in blocks.items()}


def test_seeded_tp_init_is_the_one_process_init_cut():
    """A tp model's seeded init is its blocks of one process's init of the
    same seed, so that the ranks together hold one process's model."""
    cfg = port_bert.bert_tiny()
    one = port_bert.BertClassifier(cfg, 2, seed=3).state_dict()
    for t in range(2):
        ax = TensorParallel(2, t)
        model = port_bert.BertClassifier(cfg, 2, seed=3, tp=ax)
        for name, p in model.state_dict().items():
            assert torch.equal(p, sharding.take_block(one[name], sharding.model_splits(model, name))), name


def test_param_axes_tables_look_up_their_own_names():
    """BERT's table is read by whole names (the layer index as ``*``):
    ``pos_embed`` is whole over tp although it ends like the Llama's
    ``embed.weight``, biases have axes, and a name outside the table
    raises; the Llama's table and its splits are unchanged."""
    bert = sharding.BERT_PARAM_AXES
    assert sharding.param_axes("bert.pos_embed.weight", bert) == (None, "embed")
    assert sharding.param_axes("bert.layers.11.attn.k_proj.bias", bert) == ("heads",)
    assert sharding.param_axes("bert.layers.3.attn.o_proj.bias", bert) == ("embed",)
    assert sharding.axis_dim("bert.word_embed.weight", "tp", table=bert) == 0
    assert sharding.axis_dim("bert.pos_embed.weight", "tp", table=bert) is None
    assert sharding.axis_dim("mlm_head.weight", "tp", table=bert) == 0
    assert sharding.axis_dim("mlm_head.bias", "tp", table=bert) is None
    for name in ("pos_embed.weight", "bert.layers.0.attn.q_proj.kernel", "embed.weight"):
        with pytest.raises(KeyError):
            sharding.param_axes(name, bert)
    assert sharding.param_axes("embed.weight") == ("vocab", "embed")
    assert sharding.param_axes("layers.3.attn.o_proj.weight") == ("embed", "heads")
    assert sharding.tp_dim("layers.0.mlp.down_proj.weight") == 1


def test_shard_model_takes_bert_on_replica_axes_and_refuses_the_llama(runs):
    """``shard_model`` lays BERT out on an ep mesh (BERT is whole over ep:
    FSDP2 over fsdp alone) and still refuses a Llama without ep blocks
    there, with the Llama's message."""
    for r in runs["shard"]:
        assert r["bert"] == ["fsdp"]
        assert r["llama"].startswith("the mesh has ep=2 but the model holds whole tensors: build it with "
                                     "Llama(cfg, mesh=mesh)"), r["llama"]
