"""The port's HF weight import (pytorch_operator_tpu_torch/models/llama_import.py)
against the JAX package's, on the CPU.

The same seeded HF-layout state dict (made by ``tests/test_llama_import.py``'s
``_random_state_dict``) goes through both importers: the port's state dict must equal
``params_from_jax`` of the JAX tree bit for bit, on every key, and the port's
``Llama`` on it must give JAX's logits and the plain HF-convention forward's.
Then the JAX file's cases on the port: generation and int8 decode from
imported weights, bf16 tensors with tied embeddings, the export round trip,
and the three refusals.
"""

import dataclasses

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu.models import llama_import as jax_import
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models import llama_import as port_import
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.ops import quantize as quant
from pytorch_operator_tpu_torch.workloads import generate as port_generate
from tests.test_llama_import import _random_state_dict, _torch_reference_forward

DIMS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=48)
# f32 everywhere: the two models and the plain forward differ only in the
# order of their sums.
LOGITS_ATOL = 2e-5


def _cfgs(**over):
    return jax_llama.llama_tiny(**DIMS), port_llama.llama_tiny(**DIMS, **over)


def _tokens(shape=(2, 12), seed=2):
    return np.random.default_rng(seed).integers(0, DIMS["vocab_size"], shape).astype(np.int32)


def _model(sd, cfg):
    model = port_llama.Llama(cfg, device="meta")
    model.load_state_dict(sd, assign=True)
    return model.eval()


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("source", ["f32", "bf16", "numpy"])
def test_import_equals_params_from_jax_bit_for_bit(source, param_dtype):
    jcfg, cfg = _cfgs(param_dtype=param_dtype)
    sd = _random_state_dict(jcfg)
    if source == "bf16":
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    elif source == "numpy":
        sd = {k: v.numpy() for k, v in sd.items()}
    got = port_import.import_hf_llama_state_dict(sd, cfg)
    want = params_from_jax(jax_import.import_hf_llama_state_dict(sd, jcfg), cfg)
    assert set(got) == set(want) == set(port_llama.Llama(cfg, device="meta").state_dict())
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        assert torch.equal(got[name], w), name
        if name.endswith("norm.weight"):
            assert w.dtype == torch.float32


def test_logits_match_jax_and_the_hf_forward():
    jcfg, cfg = _cfgs()
    sd = _random_state_dict(jcfg)
    tokens = _tokens()
    with torch.no_grad():
        ours = _model(port_import.import_hf_llama_state_dict(sd, cfg), cfg)(
            torch.from_numpy(tokens).long()
        ).numpy()
    ref = _torch_reference_forward(sd, jcfg, tokens)
    theirs = np.asarray(
        jax_llama.Llama(jcfg).apply({"params": jax_import.import_hf_llama_state_dict(sd, jcfg)},
                                    tokens)
    )
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=LOGITS_ATOL)
    # A wrong mapping is far outside: q and k swapped between the two layers.
    swapped = dict(sd)
    for proj in ("q_proj", "k_proj"):
        a, b = (f"model.layers.{i}.self_attn.{proj}.weight" for i in (0, 1))
        swapped[a], swapped[b] = sd[b], sd[a]
    with torch.no_grad():
        bad = _model(port_import.import_hf_llama_state_dict(swapped, cfg), cfg)(
            torch.from_numpy(tokens).long()
        ).numpy()
    assert np.abs(bad - ref).max() > 100 * LOGITS_ATOL


def _generate(model, prompt, new=8):
    gen = port_generate.make_generate(model, max_new_tokens=new)
    cache = port_generate.init_cache(model, prompt.shape[0])
    toks, _ = gen(cache, torch.from_numpy(prompt).long(), torch.Generator().manual_seed(0))
    return toks.numpy()


def test_generation_from_imported_weights_matches_jax():
    import jax

    from pytorch_operator_tpu.workloads.generate import init_cache, make_generate

    jcfg, cfg = _cfgs(decode=True, max_decode_len=24)
    sd = _random_state_dict(jcfg)
    prompt = np.random.default_rng(3).integers(0, 64, (1, 8)).astype(np.int32)
    model = _model(port_import.import_hf_llama_state_dict(sd, cfg), cfg)
    ours = _generate(model.cast_matmul_weights_(), prompt)
    dmodel = jax_llama.Llama(dataclasses.replace(jcfg, decode=True, max_decode_len=24))
    theirs, _ = make_generate(dmodel, max_new_tokens=8)(
        jax_import.import_hf_llama_state_dict(sd, jcfg), init_cache(dmodel, 1, 8), prompt,
        jax.random.key(0),
    )
    assert ours.shape == (1, 8)
    np.testing.assert_array_equal(ours, np.asarray(theirs))


def test_imported_weights_quantize_and_decode_int8():
    """Imported weights quantize to int8 (the importer's names are the ones
    the quantization rule keys on) and decode through the int8 model token
    for token as through a model on the weights dequantized apart."""
    jcfg, cfg = _cfgs(decode=True, max_decode_len=24)
    sd = port_import.import_hf_llama_state_dict(_random_state_dict(jcfg), cfg)
    qsd = quant.quantize_state_dict(sd)
    assert qsd["layers.0.attn.q_proj.weight"].dtype == torch.int8
    int8 = _model(qsd, dataclasses.replace(cfg, quantize="int8"))
    control = {
        name: quant.dequantize(t, qsd[quant.scale_name(name)]) if t.dtype == torch.int8 else t
        for name, t in qsd.items() if not name.endswith(".scale")
    }
    prompt = np.random.default_rng(3).integers(0, 64, (1, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        _generate(int8.cast_matmul_weights_(), prompt),
        _generate(_model(control, cfg).cast_matmul_weights_(), prompt),
    )


def test_bf16_tensors_and_tied_embeddings():
    jcfg, cfg = _cfgs(param_dtype=torch.bfloat16)
    sd = {k: v.to(torch.bfloat16) for k, v in _random_state_dict(jcfg).items()}
    del sd["lm_head.weight"]  # the tie_word_embeddings layout
    got = port_import.import_hf_llama_state_dict(sd, cfg)
    assert torch.equal(got["lm_head.weight"], sd["model.embed_tokens.weight"])
    assert got["lm_head.weight"].dtype == torch.bfloat16
    assert got["final_norm.weight"].dtype == torch.float32
    want = jax_import.import_hf_llama_state_dict(sd, jcfg)
    np.testing.assert_array_equal(got["lm_head.weight"].float().numpy(), want["lm_head"]["kernel"].T)


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_export_round_trips_exactly(param_dtype):
    jcfg, cfg = _cfgs(param_dtype=param_dtype)
    sd = _random_state_dict(jcfg)
    if param_dtype == torch.bfloat16:
        sd = {k: v.to(torch.bfloat16).float() for k, v in sd.items()}
    params = port_import.import_hf_llama_state_dict(sd, cfg)
    sd2 = port_import.export_hf_llama_state_dict(_model(params, cfg), cfg)
    assert set(sd2) == set(sd)
    for k, v in sd2.items():
        assert v.dtype == torch.float32 and v.is_contiguous(), k
        assert torch.equal(v, sd[k]), k
    # The JAX export of the same weights, bit for bit.
    theirs = jax_import.export_hf_llama_state_dict(jax_import.import_hf_llama_state_dict(sd, jcfg), jcfg)
    for k, v in theirs.items():
        np.testing.assert_array_equal(sd2[k].numpy(), v, err_msg=k)
    params2 = port_import.import_hf_llama_state_dict(sd2, cfg)
    for k in params:
        assert torch.equal(params2[k], params[k]), k
    # Writable, and aliasing nothing of the model.
    sd2["model.norm.weight"].add_(1.0)
    assert torch.equal(params["final_norm.weight"], sd["model.norm.weight"])


def test_moe_config_rejected_up_front():
    cfg = port_llama.llama_tiny(n_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        port_import.import_hf_llama_state_dict({}, cfg)
    with pytest.raises(NotImplementedError, match="MoE"):
        port_import.export_hf_llama_state_dict({}, cfg)


def test_shape_mismatch_rejected():
    jcfg, cfg = _cfgs()
    sd = _random_state_dict(jcfg)
    sd["model.embed_tokens.weight"] = sd["model.embed_tokens.weight"][:, :16]
    with pytest.raises(ValueError, match="expected shape"):
        port_import.import_hf_llama_state_dict(sd, cfg)


def test_missing_key_rejected():
    jcfg, cfg = _cfgs()
    sd = _random_state_dict(jcfg)
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="up_proj"):
        port_import.import_hf_llama_state_dict(sd, cfg)
