"""The port's BERT path (``models/bert.py``, ``workloads/bert_fsdp.py``)
against the JAX package's, on the CPU, at ``bert_tiny``.

- ``Bert``/``BertClassifier``: the sequence output, the pooled output, the
  logits and every parameter gradient against JAX's on the JAX weights
  carried across (``convert.bert_params_from_jax``), f32, with and without
  ``type_ids`` and a pad mask; bf16 compute at a looser limit; two planted
  faults (the pad mask dropped; GELU's exact form for the tanh one) read
  above the f32 limit on weights scaled ×10.
- JAX's pad-invariance check (``tests/test_models_transformer.py:127-150``):
  a padded position changes nothing, a real one changes the row.
- ``BertMLM``'s logits and gradients; a ``pad_mask`` that is not ``[B, S]``
  bool is refused by name.
- ``synthetic_topic_batch`` byte-equal to JAX's; the parameter count and
  ``params_m`` equal JAX's tree (no ``type_embed``: ``bert_fsdp``'s init
  sees no ``type_ids``) at ``bert_tiny`` and BERT-base.
- ``bert_fsdp.run``: JAX's result keys, and its per-step losses against
  JAX's ``run`` from the same initial parameters under the constant and the
  cosine schedules and with ``grad_clip``; the prefetched feed's losses
  equal the inline feed's; a tp that does not divide the heads, ``d_ff``
  or the vocabulary refused naming that dim (as JAX's run refuses it), and
  a mesh whose size is not the world's. ``tests/test_torch_bert_tp.py``
  holds BERT over tp, sp, ep and pp.

Limits, from readings on the CPU: f32 outputs within ``F32_ATOL``
(readings ≤ 7.2e-7 at the sequence output, the pooled output and the
logits), gradients within ``F32_GRAD_RTOL`` by relative L2 (readings
≤ 4.3e-7); bf16 outputs within ``BF16_ATOL`` (readings: the sequence output
3.1e-2, one bf16 step at its largest values; the pooled output 2.9e-3, the
logits 3.7e-4) and gradients ``BF16_GRAD_RTOL`` (≤ 2.6e-2);
``bert_fsdp.run``'s f32 losses within ``RUN_LOSS_RTOL`` of JAX's over 1 + 4
steps (readings ≤ 1.7e-7).
"""

import dataclasses

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from pytorch_operator_tpu.models import bert as jax_bert
from pytorch_operator_tpu.workloads import bert_fsdp as jax_fsdp
from pytorch_operator_tpu.workloads import trainer as jax_trainer
from pytorch_operator_tpu_torch.models import bert as port_bert
from pytorch_operator_tpu_torch.models.convert import bert_params_from_jax
from pytorch_operator_tpu_torch.workloads import bert_fsdp

F32_ATOL = 2e-6
F32_GRAD_RTOL = 2e-5
BF16_ATOL = 0.1
BF16_GRAD_RTOL = 0.2
RUN_LOSS_RTOL = 1e-5
B, S, CLASSES = 3, 16, 3
LENGTHS = [16, 9, 4]

CASES = {
    "plain": dict(types=False, pad=False),
    "type_ids": dict(types=True, pad=False),
    "pad_mask": dict(types=False, pad=True),
    "type_ids_pad_mask": dict(types=True, pad=True),
}


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 128, (B, S)).astype(np.int32)
    types = rng.integers(0, 2, (B, S)).astype(np.int32)
    pad = np.arange(S)[None, :] < np.array(LENGTHS)[:, None]
    labels = rng.integers(0, CLASSES, (B,)).astype(np.int32)
    return toks, types, pad, labels


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a)).long() if a.dtype != bool else torch.from_numpy(a)


def _models(types: bool, jdt=jnp.float32, pdt=torch.float32, head="classifier"):
    toks, type_ids, pad, _ = _inputs()
    jcfg = jax_bert.bert_tiny(dtype=jdt)
    jm = (jax_bert.BertClassifier(jcfg, num_classes=CLASSES) if head == "classifier"
          else jax_bert.BertMLM(jcfg))
    variables = jm.init(jax.random.key(0), toks, type_ids if types else None, pad)
    pcfg = port_bert.bert_tiny(dtype=pdt)
    pm = (port_bert.BertClassifier(pcfg, CLASSES, type_embed=types) if head == "classifier"
          else port_bert.BertMLM(pcfg, type_embed=types))
    pm.load_state_dict(bert_params_from_jax(variables["params"]))
    return jcfg, jm, variables, pm


def _grad_gaps(grads, pm) -> dict:
    """Each gradient's relative L2 gap to JAX's. The key bias's gradient is
    zero in exact arithmetic (the softmax is invariant to a shift of a
    query's scores), so both are held to be near zero instead."""
    want = bert_params_from_jax(grads["params"])
    assert set(want) == {n for n, _ in pm.named_parameters()}
    gaps = {}
    for n, p in pm.named_parameters():
        g = torch.zeros_like(want[n]) if p.grad is None else p.grad.float()  # MLM: the pooler's
        if n.endswith("k_proj.bias") or not want[n].any():
            assert max(float(g.norm()), float(want[n].norm())) < 1e-4, n
        else:
            gaps[n] = float((g - want[n]).norm() / want[n].norm())
    return gaps


def _compare(case: str, jdt, pdt):
    kw = CASES[case]
    toks, type_ids, pad, labels = _inputs()
    type_ids = type_ids if kw["types"] else None
    pad = pad if kw["pad"] else None
    jcfg, jm, variables, pm = _models(kw["types"], jdt, pdt)

    def loss_fn(v):
        logits = jm.apply(v, toks, type_ids, pad)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean(), logits

    (want_loss, want_logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables)
    want_seq, want_pooled = jax_bert.Bert(jcfg).apply(
        {"params": variables["params"]["bert"]}, toks, type_ids, pad)
    seq, pooled = pm.bert(_t(toks), _t(type_ids), _t(pad))
    logits = pm(_t(toks), _t(type_ids), _t(pad))
    F.cross_entropy(logits, _t(labels)).backward()
    gaps = {
        "seq": float(np.abs(seq.detach().float().numpy() - np.asarray(want_seq, np.float32)).max()),
        "pooled": float(np.abs(pooled.detach().float().numpy() - np.asarray(want_pooled, np.float32)).max()),
        "logits": float(np.abs(logits.detach().numpy() - np.asarray(want_logits)).max()),
    }
    assert logits.dtype == torch.float32 and seq.dtype == pdt and pooled.dtype == pdt
    return gaps, _grad_gaps(grads, pm), pm


@pytest.mark.parametrize("case", sorted(CASES))
def test_bert_matches_jax_f32(case):
    gaps, grad_gaps, _ = _compare(case, jnp.float32, torch.float32)
    assert max(gaps.values()) <= F32_ATOL, gaps
    assert max(grad_gaps.values()) <= F32_GRAD_RTOL, max(grad_gaps.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("case", ["plain", "type_ids_pad_mask"])
def test_bert_matches_jax_bf16(case):
    gaps, grad_gaps, _ = _compare(case, jnp.bfloat16, torch.bfloat16)
    assert max(gaps.values()) <= BF16_ATOL, gaps
    assert max(grad_gaps.values()) <= BF16_GRAD_RTOL, max(grad_gaps.items(), key=lambda kv: kv[1])


def test_planted_faults_read_above_the_limit(monkeypatch):
    """On weights scaled ×10 (so that GELU's inputs are of order one):
    dropping the pad mask moves the logits, and GELU's exact (erf) form in
    place of the tanh one moves the sequence output, each past the f32
    limit that the sound port holds on the same weights."""
    import flax.linen as nn

    toks, _, pad, _ = _inputs()
    jcfg, jm, variables, pm = _models(False)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 10 if "kernel" in str(path) or "embedding" in str(path) else a,
        nn.meta.unbox(variables["params"]))
    pm.load_state_dict(bert_params_from_jax(params))
    want = np.asarray(jm.apply({"params": params}, toks, None, pad))
    want_seq = np.asarray(jax_bert.Bert(jcfg).apply({"params": params["bert"]}, toks, None, pad)[0])
    gelu = F.gelu
    with torch.no_grad():
        sound = pm(_t(toks), None, _t(pad)).numpy()
        sound_seq = pm.bert(_t(toks), None, _t(pad))[0].numpy()
        no_mask = pm(_t(toks)).numpy()
        monkeypatch.setattr(F, "gelu", lambda x, approximate="none": gelu(x))
        erf_seq = pm.bert(_t(toks), None, _t(pad))[0].numpy()
    limit = 10 * F32_ATOL  # the larger weights carry larger roundings
    assert np.abs(sound - want).max() <= limit and np.abs(sound_seq - want_seq).max() <= limit
    assert np.abs(no_mask - want).max() > 10 * limit
    assert np.abs(erf_seq - want_seq).max() > 10 * limit


def test_pad_invariance():
    """A padded position's token changes nothing; a real one changes its row."""
    _, _, _, pm = _models(False)
    tokens = torch.ones((4, 32), dtype=torch.long)
    pad = torch.arange(32)[None, :] < torch.tensor([32, 20, 10, 5])[:, None]
    with torch.no_grad():
        base = pm(tokens, None, pad)
        padded = tokens.clone()
        padded[3, 20] = 7
        real = tokens.clone()
        real[0, 1] = 7
        np.testing.assert_allclose(pm(padded, None, pad).numpy(), base.numpy(), atol=1e-5)
        assert float((pm(real, None, pad)[0] - base[0]).abs().max()) > 1e-6
    with pytest.raises(ValueError, match="pad_mask must be a bool"):
        pm(tokens, None, pad.long())
    with pytest.raises(ValueError, match="pad_mask must be a bool"):
        pm(tokens, None, pad[:, :16])


def test_mlm_logits_match_jax():
    toks, type_ids, pad, _ = _inputs()
    _, jm, variables, pm = _models(True, head="mlm")

    def loss_fn(v):
        logits = jm.apply(v, toks, type_ids, pad)
        return jnp.mean(logits ** 2), logits

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables)
    logits = pm(_t(toks), _t(type_ids), _t(pad))
    assert tuple(logits.shape) == (B, S, 128) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), atol=F32_ATOL)
    logits.square().mean().backward()
    assert max(_grad_gaps(grads, pm).values()) <= F32_GRAD_RTOL


@pytest.mark.parametrize("args", [(4, 16, 128, 0, 2), (5, 7, 30522, 9, 3)])
def test_synthetic_topic_batch_equals_jax(args):
    for got, want in zip(bert_fsdp.synthetic_topic_batch(*args), jax_fsdp.synthetic_topic_batch(*args)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("config", ["tiny", "base"])
def test_param_count_equals_jax(config):
    jcfg = jax_bert.bert_base() if config == "base" else jax_bert.bert_tiny()
    pcfg = port_bert.bert_base() if config == "base" else port_bert.bert_tiny()
    shapes = jax.eval_shape(
        lambda k: jax_bert.BertClassifier(jcfg, num_classes=2).init(k, jnp.zeros((1, 64), jnp.int32)),
        jax.random.key(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        model = port_bert.BertClassifier(pcfg, 2)
    got = sum(p.numel() for p in model.parameters())
    assert got == want == {"tiny": 83_650, "base": 109_482_242}[config]
    assert round(got / 1e6, 1) == {"tiny": 0.1, "base": 109.5}[config]
    assert all(p.dtype == torch.float32 for p in model.parameters())


RUN = dict(batch_size=16, seq_len=32, steps=4, warmup=1, lr=3e-4)
SCHEDULES = {
    "constant": {},
    "cosine": dict(lr_warmup_steps=2),
    "clip": dict(grad_clip=0.05),
}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's ``run`` under each schedule, every step's loss recorded around
    its train step (its result keeps the last), from its key-0 init."""
    out = {}
    real = jax_trainer.throughput_loop
    for name, over in SCHEDULES.items():
        losses = []

        def loop(train_step, state, batches, **kw):
            def recorded(state, b):
                state, loss = train_step(state, b)
                losses.append(float(loss))
                return state, loss

            return real(recorded, state, batches, **kw)

        jax_trainer.throughput_loop = loop
        try:
            result = jax_fsdp.run(log=lambda *a: None, **RUN, **over)
        finally:
            jax_trainer.throughput_loop = real
        out[name] = (result, losses)
    model = jax_bert.BertClassifier(jax_bert.bert_tiny(), num_classes=2)
    init = model.init(jax.random.key(0), np.zeros((1, RUN["seq_len"]), np.int32))["params"]
    return out, bert_params_from_jax(init)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_run_follows_jax(jax_runs, schedule):
    runs, init = jax_runs
    want, want_losses = runs[schedule]
    r = bert_fsdp.run(init_params=init, log=lambda m: None, **RUN, **SCHEDULES[schedule])
    assert set(r) - set(want) == {"device", "peak_mem_bytes", "losses", "accuracies", "step_s",
                                  "param_bytes", "optimizer_state_bytes", "mesh", "world", "backend"}
    assert set(want) <= set(r)
    for key in ("metric", "unit", "model", "params_m", "n_layers", "d_model"):
        assert r[key] == want[key], key
    assert (r["devices"], r["world"], r["mesh"], r["device"]) == (1, 1, {"fsdp": 1}, "cpu")
    assert len(r["losses"]) == len(want_losses) == RUN["warmup"] + RUN["steps"]
    np.testing.assert_allclose(r["losses"], want_losses, rtol=RUN_LOSS_RTOL)
    assert r["final_loss"] == pytest.approx(want["final_loss"], abs=1e-4)
    assert r["final_accuracy"] == want["final_accuracy"]
    assert r["optimizer_state_bytes"] >= 2 * r["param_bytes"] == 2 * 4 * 83_650


def test_prefetched_run_equals_inline():
    """``--prefetch 2`` feeds the same batches in the same order: the
    losses equal the inline run's bit for bit."""
    runs = [bert_fsdp.run(prefetch=p, log=lambda m: None, **RUN) for p in (0, 2)]
    assert runs[0]["losses"] == runs[1]["losses"] and runs[0]["accuracies"] == runs[1]["accuracies"]


# Each refused layout changes one dim of bert_tiny (4 heads, d_ff 128, a
# vocabulary of 128): (config overrides, tp, JAX's mesh over the pytest
# process's 8 virtual devices).
TP_REFUSALS = {
    "n_heads": ({}, 8, "tp=8"),
    "vocab_size": ({"vocab_size": 130}, 4, "dp=2,tp=4"),
    "d_ff": ({"d_ff": 130}, 4, "dp=2,tp=4"),
}


@pytest.mark.parametrize("dim", [*TP_REFUSALS, "mesh_size"])
def test_refused_layouts_name_the_dim(dim, monkeypatch):
    """A tp that does not divide the heads, ``d_ff`` or the vocabulary is
    refused naming that dim and no other, where JAX's ``bert_fsdp.run``
    refuses the same layout (its partitioner's ValueError); a mesh whose
    sizes do not multiply to the world's is refused by ``run``."""
    from pytorch_operator_tpu_torch.parallel.sharding import TensorParallel

    if dim == "mesh_size":
        with pytest.raises(ValueError, match=r"axis product 2 != device count 1"):
            bert_fsdp.run(mesh_spec="tp=2", log=lambda m: None, **RUN)
        return
    over, tp, jax_mesh = TP_REFUSALS[dim]
    with pytest.raises(ValueError) as refused:
        port_bert.BertClassifier(port_bert.bert_tiny(**over), 2, tp=TensorParallel(tp, 0))
    msg = str(refused.value)
    assert msg.startswith(f"tp={tp} does not divide {dim}="), msg
    assert all(f"{other}=" not in msg for other in TP_REFUSALS if other != dim), msg
    tiny = jax_bert.bert_tiny
    monkeypatch.setattr(jax_bert, "bert_tiny", lambda **kw: tiny(**{**over, **kw}))
    with pytest.raises(ValueError, match="divisible"):
        jax_fsdp.run(mesh_spec=jax_mesh, batch_size=8, seq_len=16, steps=1, warmup=1, log=lambda m: None)


def test_config_matches_jax():
    for name in ("bert_base", "bert_tiny"):
        j, p = dataclasses.asdict(getattr(jax_bert, name)()), dataclasses.asdict(getattr(port_bert, name)())
        assert {k: v for k, v in j.items() if "dtype" not in k} == {k: v for k, v in p.items() if "dtype" not in k}
        assert str(p["dtype"]).replace("torch.", "") == jnp.dtype(j["dtype"]).name
