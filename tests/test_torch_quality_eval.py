"""The port's quality_eval (pytorch_operator_tpu_torch/workloads/
quality_eval.py) against the JAX package's, on the CPU.

- ``eval_serving_stream`` on the same carried weights and the same tokens,
  chunked through the cache-mode decode stack: the full-precision tree, a
  JAX ``quantize_tree`` tree carried bit for bit (int8 weights), and the
  same with an int8 KV cache. Tolerance on the mean loss: 1e-5 relative
  for all three (f32 on both sides, sums in another order; readings 4.9e-8,
  1.6e-8 and 6.5e-8). The argmax must equal JAX's at every position where
  JAX's top-2 logit gap exceeds ``GAP_TOL``.
- ``run`` end to end on a checkpoint that the port's llama_train wrote in
  the test: the JAX result keys, the deltas, the drift record, and the fp
  serving-path loss equal to the training path's loss on the same rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tests.jaxenv  # noqa: F401

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu.workloads import quality_eval as jax_quality
from pytorch_operator_tpu_torch.data import pack_arrays
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.workloads import generate as port_generate
from pytorch_operator_tpu_torch.workloads import llama_train, quality_eval, trainer

B, S, CHUNK, L = 2, 40, 16, 48
LOSS_RTOL = 1e-5
# A logit gap below this may flip the argmax between the two sums.
GAP_TOL = 1e-3


@pytest.fixture(scope="module")
def trees():
    import flax.linen as nn
    import jax

    from pytorch_operator_tpu.ops.quantize import quantize_tree

    jcfg = jax_llama.llama_tiny()
    params = jax.device_get(
        nn.meta.unbox(jax_llama.Llama(jcfg).init(jax.random.key(0), np.zeros((1, 8), np.int32))["params"])
    )
    return params, jax.device_get(jax.jit(quantize_tree)(params))


def _jax_stream_logits(cfg, params, tokens):
    """The logits of JAX's ``eval_serving_stream`` chunk loop, which the
    function itself does not return."""
    import jax.numpy as jnp

    from pytorch_operator_tpu.models.llama import decode_forward, init_decode_cache

    model = jax_llama.Llama(dataclasses.replace(cfg, prefill_mode="cache"))
    cache = init_decode_cache(cfg, B)
    out = []
    for start in range(0, S, CHUNK):
        size = min(CHUNK, S - start)
        pos = jnp.broadcast_to(jnp.arange(start, start + size, dtype=jnp.int32), (B, size))
        logits, cache = decode_forward(
            model, params, cache, tokens[:, start : start + size], pos, return_hidden=False
        )
        out.append(np.asarray(logits, np.float32))
    return np.concatenate(out, axis=1)[:, : S - 1]


@pytest.mark.parametrize("variant", ["fp", "int8", "int8_kv8"])
def test_eval_serving_stream_matches_jax(trees, variant):
    params, qtree = trees
    quant = None if variant == "fp" else "int8"
    kv = "int8" if variant == "int8_kv8" else None
    jcfg = jax_llama.llama_tiny(decode=True, max_decode_len=L, quantize=quant, kv_quantize=kv)
    pcfg = port_llama.llama_tiny(decode=True, max_decode_len=L, quantize=quant, kv_quantize=kv)
    tree = params if quant is None else qtree
    tokens = np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)
    want_loss, want_pred = jax_quality.eval_serving_stream(jcfg, tree, tokens, chunk=CHUNK)
    model, _ = port_generate.load_params(
        pcfg, config="tiny", device="cpu", jax_params=tree, quantize=quant, log=lambda m: None
    )
    loss, pred = quality_eval.eval_serving_stream(
        pcfg, model.state_dict(), torch.from_numpy(tokens).long(), chunk=CHUNK
    )
    assert pred.shape == want_pred.shape == (B, S - 1)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    logits = _jax_stream_logits(jcfg, tree, tokens)
    np.testing.assert_array_equal(logits.argmax(-1), want_pred)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > GAP_TOL
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(pred[clear], want_pred[clear])


def test_run_end_to_end_on_a_port_checkpoint(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    # A learnable byte stream: each row counts up from a random start.
    start = rng.integers(0, 256, (48, 1))
    toks = ((start + np.arange(32)[None]) % 256).astype(np.int32)
    pack_arrays(tmp_path / "train.bin", {"tokens": toks[:40]})
    pack_arrays(tmp_path / "eval.bin", {"tokens": toks[40:]})
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", str(tmp_path / "ck"))
    trained = llama_train.run(
        config="tiny", batch_size=8, seq_len=32, steps=4, warmup=1, lr=1e-2,
        data_file=str(tmp_path / "train.bin"), checkpoint_every=5, device="cpu",
        log=lambda m: None,
    )
    monkeypatch.delenv("TPUJOB_CHECKPOINT_DIR")
    r = quality_eval.run(
        config="tiny", restore=str(tmp_path / "ck"), eval_file=str(tmp_path / "eval.bin"),
        eval_batches=2, batch_size=4, chunk=CHUNK, drift_tokens=24, drift_window=8,
        drift_prompt=16, device="cpu", log=lambda m: None,
    )
    jax_keys = {
        "config", "restored_step", "params_m", "eval_rows", "eval_seq_len", "fp_eval_loss",
        "int8_eval_loss", "int8_kv8_eval_loss", "int8_loss_delta", "int8_kv8_loss_delta",
        "int8_eval_argmax_agreement", "int8_kv8_eval_argmax_agreement", "drift",
    }
    assert set(r) == jax_keys | {"device", "drift_rollout_s"}
    assert r["restored_step"] == trained["end_step"] == 5
    assert (r["eval_rows"], r["eval_seq_len"], r["device"]) == (8, 32, "cpu")
    assert r["int8_loss_delta"] == pytest.approx(r["int8_eval_loss"] - r["fp_eval_loss"], abs=1e-4)
    for name in ("int8", "int8_kv8"):
        assert 0.5 <= r[f"{name}_eval_argmax_agreement"] <= 1.0
        d = r["drift"][name]
        assert (d["tokens"], d["window"]) == (24, 8) and 0.0 <= d["last"] <= 1.0
    # The fp serving path against the training path's loss on the same rows.
    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager
    from pytorch_operator_tpu_torch.data import open_loader

    _, params = CheckpointManager(tmp_path / "ck", create=False).restore_subtree("params")
    model = port_llama.Llama(port_llama.llama_tiny())
    model.load_state_dict(params)
    loader = open_loader(str(tmp_path / "eval.bin"), 4, seed=1)
    rows = np.concatenate([np.array(loader.next_batch()[2]["tokens"], copy=True) for _ in range(2)])
    loader.close()
    train_loss = float(trainer.make_lm_eval_step(model)(torch.from_numpy(rows).long()))
    assert r["fp_eval_loss"] == pytest.approx(train_loss, abs=1e-4)
    assert train_loss < 5.0  # learned: chance is ln 256 = 5.55
