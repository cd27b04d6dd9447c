"""The port's int8 weights and int8 KV cache (pytorch_operator_tpu_torch/
ops/quantize.py and its uses in models/llama.py, models/convert.py and
workloads/generate.py) against the JAX package's, on the CPU.

- ``quantize`` is bit-equal to the JAX ``quantize`` run op by op (both
  divide), except the scale of an all-zero channel (JAX's CPU flushes the
  subnormal ``tiny / 127`` to 0, torch keeps it; both dequantize to 0). Under
  ``jax.jit`` XLA multiplies by a reciprocal: within 1 ulp per scale and one
  level per ``q``.
- The rule puts one scale per output row on every matmul weight, the
  embedding and the head; norms stay f32. ``state_bytes`` equals
  ``tree_bytes``.
- A JAX tree quantized by ``quantize_tree`` is carried across bit for bit,
  and the port's int8 model then gives JAX's ``quantize="int8"`` logits
  within 1e-4 (f32 ``llama_tiny``), its int8 + int8-KV serving forward JAX's
  hidden states within 1e-4 (uniform, per-row, chunked prefill) and its cache
  slabs, and JAX's greedy tokens.
- A MoE tree (4 experts): the banks int8 with one scale a column over their
  input axis (``[L, E, 1, ·]``), the router untouched, carried bit for bit;
  the int8 MoE model's logits within 1e-4 of JAX's.
"""

import dataclasses

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu.ops import quantize as jax_quant
from pytorch_operator_tpu.workloads import generate as jax_generate
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.ops import quantize as quant
from pytorch_operator_tpu_torch.workloads import generate as port_generate

TOL = 1e-4
PROMPT, NEW = 8, 3
L = PROMPT + NEW + 1


@pytest.fixture(scope="module")
def trees():
    """(the full-precision JAX llama_tiny tree, its ``jax.jit(quantize_tree)``
    as JAX's load_params makes it), both on the host."""
    import flax.linen as nn
    import jax

    fp = nn.meta.unbox(
        jax_llama.Llama(jax_llama.llama_tiny()).init(
            jax.random.key(0), np.zeros((1, PROMPT), np.int32)
        )["params"]
    )
    return jax.device_get(fp), jax.device_get(jax.jit(jax_quant.quantize_tree)(fp))


def _weights(seed=0):
    """A [64, 48] weight at std 0.02 with a zero, a 1e30 and a -3 row and
    the same three columns."""
    w = (np.random.default_rng(seed).standard_normal((64, 48)) * 0.02).astype(np.float32)
    for i, v in ((6, 1e30), (7, -3.0), (5, 0.0)):
        w[i, :] = v
        w[:, i] = v
    return w


@pytest.mark.parametrize("dim", [-1, -2, 0])
def test_quantize_bit_equal_to_jax_op_by_op(dim):
    import jax.numpy as jnp

    w = _weights()
    want = jax_quant.quantize(jnp.asarray(w), axis=dim)
    got = quant.quantize(torch.from_numpy(w), dim)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    ws, gs = np.asarray(want.scale), got.scale.numpy()
    zero = (np.abs(w).max(axis=dim, keepdims=True) == 0).reshape(ws.shape)
    assert zero.sum() == 1  # the zero channel along this dim
    np.testing.assert_array_equal(gs[~zero], ws[~zero])
    # JAX's scale is 0 there, the port's subnormal; both dequantize to 0.
    assert (ws[zero] == 0).all() and (gs[zero] == np.float32(np.finfo(np.float32).tiny) / 127).all()
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))


def test_quantize_within_one_ulp_of_jitted_quantize():
    """Against ``jax.jit``, where XLA multiplies by 1/127: each scale within
    1 ulp, each ``q`` within one level."""
    import jax
    import jax.numpy as jnp

    w = (np.random.default_rng(1).standard_normal((1024, 1024)) * 0.02).astype(np.float32)
    for dim in (-1, -2):
        want = jax.jit(lambda x, d=dim: jax_quant.quantize(x, axis=d))(jnp.asarray(w))
        got = quant.quantize(torch.from_numpy(w), dim)
        ws, gs = np.asarray(want.scale), got.scale.numpy()
        assert (np.abs(gs - ws) <= np.spacing(np.maximum(np.abs(ws), np.abs(gs)))).all()
        levels = np.abs(got.q.numpy().astype(np.int32) - np.asarray(want.q).astype(np.int32))
        assert levels.max() <= 1


def test_error_bound_and_dequantize_dtypes():
    w = torch.from_numpy(_weights(2))[8:]  # rows without the 1e30 channel
    qt = quant.quantize(w, -1)
    err = (qt.dequantize() - w).abs()
    assert (err <= qt.scale / 2 + 1e-7).all()
    torch.testing.assert_close(qt.scale[:, 0], w.abs().amax(-1) / 127, rtol=1e-6, atol=0)
    # One rounding: dtype(f32(q) * scale), the reference's dequantize.
    for dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(qt.dequantize(dtype), (qt.q.float() * qt.scale).to(dtype))


def test_rule_scale_shapes_on_every_llama_weight():
    cfg = port_llama.llama_tiny()
    sd = port_llama.Llama(cfg).init_weights(torch.Generator().manual_seed(0)).state_dict()
    qsd = quant.quantize_state_dict(sd)
    quantized = [n for n in sd if quant.is_quantized(n)]
    # 7 matmul weights a layer, the embedding and the head.
    assert len(quantized) == 7 * cfg.n_layers + 2
    assert "embed.weight" in quantized and "lm_head.weight" in quantized
    for name, w in sd.items():
        if name in quantized:
            assert qsd[name].dtype == torch.int8 and qsd[name].shape == w.shape, name
            assert qsd[quant.scale_name(name)].shape == (w.shape[0], 1), name
            assert qsd[quant.scale_name(name)].dtype == torch.float32
        else:
            assert name.endswith("norm.weight") and qsd[name] is w
    # The int8 model holds exactly these entries.
    int8 = port_llama.Llama(dataclasses.replace(cfg, quantize="int8"))
    assert set(int8.state_dict()) == set(qsd)
    int8.load_state_dict(qsd)


def test_state_bytes_equals_tree_bytes(trees):
    fp, _ = trees
    cfg = port_llama.llama_tiny()
    qsd = quant.quantize_state_dict(params_from_jax(fp, cfg))
    assert quant.state_bytes(qsd) == jax_quant.tree_bytes(jax_quant.quantize_tree(fp))


def test_params_from_jax_carries_quantized_tree_bit_for_bit(trees):
    fp, qt = trees
    cfg = port_llama.llama_tiny(quantize="int8")
    sd = params_from_jax(qt, cfg)
    M, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def pair(name, leaf, to_port):
        np.testing.assert_array_equal(sd[name + ".weight"].numpy(), to_port(np.asarray(leaf.q)))
        np.testing.assert_array_equal(sd[name + ".scale"].numpy(), to_port(np.asarray(leaf.scale)))
        assert sd[name + ".weight"].dtype == torch.int8

    pair("embed", qt["embed"]["embedding"], lambda a: a)
    pair("lm_head", qt["lm_head"]["kernel"], lambda a: a.T)
    layers = qt["layers"]
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        for proj, heads in (("q_proj", H), ("k_proj", K), ("v_proj", K)):
            pair(p + "attn." + proj, layers["attn"][proj]["kernel"],
                 lambda a: a[i].reshape(a.shape[1], heads * D).T)
        pair(p + "attn.o_proj", layers["attn"]["o_proj"]["kernel"], lambda a: a[i].T)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            pair(p + "mlp." + proj, layers["mlp"][proj]["kernel"], lambda a: a[i].T)
        np.testing.assert_array_equal(
            sd[p + "attn_norm.weight"].numpy(), np.asarray(layers["attn_norm"]["scale"][i])
        )
    assert sd["embed.scale"].shape == (cfg.vocab_size, 1)
    assert sd["layers.0.attn.q_proj.scale"].shape == (H * D, 1)
    assert sd["lm_head.scale"].shape == (cfg.vocab_size, 1)
    assert quant.state_bytes(sd) == jax_quant.tree_bytes(qt)
    # A tree whose quantization disagrees with the config is refused.
    with pytest.raises(ValueError, match="embed/embedding is not quantized"):
        params_from_jax(fp, cfg)
    with pytest.raises(ValueError, match="embed/embedding is quantized"):
        params_from_jax(qt, port_llama.llama_tiny())
    assert M == sd["embed.weight"].shape[1]


def _int8_model(qt, **over):
    cfg = port_llama.llama_tiny(attn_impl="flash", quantize="int8", **over)
    model, _ = port_generate.load_params(
        cfg, config="tiny", device="cpu", jax_params=qt, quantize="int8", log=lambda m: None
    )
    return model


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def test_full_forward_logits_match_jax_int8(trees):
    _, qt = trees
    jcfg = jax_llama.llama_tiny(attn_impl="flash", quantize="int8")
    toks = _tokens(2, 16)
    ref = np.asarray(jax_llama.Llama(jcfg).apply({"params": qt}, toks))
    model = _int8_model(qt)
    out = model(torch.from_numpy(toks).long())
    assert out.dtype == torch.float32 and out.shape == (2, 16, 256)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL)
    hidden = model(torch.from_numpy(toks).long(), return_hidden=True)
    head = model.head_kernel()
    assert head.dtype == torch.float32 and head.shape == (64, 256)
    np.testing.assert_allclose((hidden @ head).numpy(), ref, atol=TOL)
    np.testing.assert_array_equal(
        head.numpy(), np.asarray(jax_llama.Llama.head_kernel(qt))
    )


def _check_kv8_cache(jc, pc, n_layers, report):
    """q slabs equal or one level apart (the share reported, held under 1%);
    scales within 1e-5 relative."""
    off = total = 0
    for i in range(n_layers):
        j, p = jc[f"layer_{i}"]["attn"], pc[f"layer_{i}"]["attn"]
        for name in ("cached_key", "cached_value"):
            a = p[name].numpy().astype(np.int32)
            b = np.asarray(j[name]).astype(np.int32)
            assert p[name].dtype == torch.int8 and np.abs(a - b).max() <= 1, name
            off, total = off + int((a != b).sum()), total + a.size
        for name in ("key_scale", "value_scale"):
            assert p[name].shape == j[name].shape and p[name].dtype == torch.float32
            np.testing.assert_allclose(p[name].numpy(), np.asarray(j[name]), rtol=1e-5, atol=0)
    report.append(off / total)
    assert off / total < 0.01


@pytest.mark.parametrize(
    "per_row,prefill_mode",
    [(False, "self"), (True, "self"), (False, "cache")],
    ids=["uniform", "per_row", "chunked_prefill"],
)
def test_decode_forward_int8_kv8_matches_jax(trees, per_row, prefill_mode):
    """Prefill (one shot, or two chunks under prefill_mode="cache"), then
    three single-token steps; per-row steps sit at different depths."""
    _, qt = trees
    B = 2
    over = dict(
        decode=True, max_decode_len=L, decode_per_row=per_row,
        prefill_mode=prefill_mode, kv_quantize="int8",
    )
    jcfg = jax_llama.llama_tiny(attn_impl="flash", quantize="int8", **over)
    jmodel = jax_llama.Llama(jcfg)
    model = _int8_model(qt, **over)
    jcache = jax_llama.init_decode_cache(jcfg, B)
    pcache = port_llama.init_decode_cache(model.cfg, B)
    shares = []

    def step(tokens, positions):
        nonlocal jcache
        jh, jcache = jax_llama.decode_forward(jmodel, qt, jcache, tokens, positions)
        ph, _ = port_llama.decode_forward(
            model, pcache, torch.from_numpy(tokens).long(),
            None if positions is None else torch.from_numpy(positions).long(),
        )
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=TOL)

    prompt = _tokens(B, PROMPT)
    if prefill_mode == "cache":
        half = PROMPT // 2
        pos = np.broadcast_to(np.arange(PROMPT, dtype=np.int32), (B, PROMPT))
        step(prompt[:, :half], np.ascontiguousarray(pos[:, :half]))
        step(prompt[:, half:], np.ascontiguousarray(pos[:, half:]))
    else:
        step(prompt, None)
    _check_kv8_cache(jcache, pcache, jcfg.n_layers, shares)
    tok = _tokens(B, NEW, seed=2)
    for i in range(NEW):
        pos = np.full((B, 1), PROMPT + i, np.int32)
        if per_row:
            pos[1] += 1  # row 1 runs one slot ahead of row 0
        step(tok[:, i : i + 1], pos)
    _check_kv8_cache(jcache, pcache, jcfg.n_layers, shares)
    print(f"kv8 q slab entries one level apart: {shares}")


def test_kv8_self_prefill_hidden_equals_unquantized_cache(trees):
    """A "self" prefill attends over the incoming, unquantized k and v: an
    int8 cache changes what is stored, not the prefill's hidden states."""
    _, qt = trees
    toks = torch.from_numpy(_tokens(2, PROMPT)).long()
    out = {}
    for kv in (None, "int8"):
        model = _int8_model(qt, decode=True, max_decode_len=L, kv_quantize=kv)
        cache = port_llama.init_decode_cache(model.cfg, 2)
        out[kv], _ = port_llama.decode_forward(model, cache, toks)
        assert cache["layer_0"]["attn"]["cached_key"].dtype == (torch.int8 if kv else torch.float32)
    assert torch.equal(out[None], out["int8"])


def test_greedy_tokens_equal_jax_int8_kv8(trees):
    import jax

    _, qt = trees
    over = dict(decode=True, max_decode_len=PROMPT + 8, kv_quantize="int8")
    jcfg = jax_llama.llama_tiny(quantize="int8", **over)
    jmodel = jax_llama.Llama(jcfg)
    prompt = _tokens(2, PROMPT)
    ref, _ = jax_generate.make_generate(jmodel, max_new_tokens=8)(
        qt, jax_generate.init_cache(jmodel, 2, PROMPT), prompt, jax.random.key(0)
    )
    model = _int8_model(qt, **over)
    toks, _ = port_generate.make_generate(model, max_new_tokens=8)(
        port_generate.init_cache(model, 2), torch.from_numpy(prompt).long(), torch.Generator()
    )
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref))


def test_int8_model_holds_no_full_precision_weight(trees):
    """load_params on the full-precision JAX tree quantizes with the port's
    quantizer (within one level of JAX's jitted one); the model holds int8
    and f32 scales only besides its norms, refuses a random init, and its
    cast to the compute dtype leaves the int8 tensors alone."""
    import jax

    fp, qt = trees
    cfg = port_llama.llama_tiny(quantize="int8", dtype=torch.bfloat16)
    model, n_params = port_generate.load_params(
        cfg, config="tiny", device="cpu", jax_params=fp, quantize="int8", log=lambda m: None
    )
    carried = params_from_jax(qt, cfg)
    for name, t in model.state_dict().items():
        if name.endswith("norm.weight"):
            assert t.dtype == torch.float32
        elif name.endswith(".scale"):
            assert t.dtype == torch.float32 and t.shape[1] == 1
            np.testing.assert_allclose(t.numpy(), carried[name].numpy(), rtol=2e-7)
        else:
            assert t.dtype == torch.int8, name
            assert (t.int() - carried[name].int()).abs().max() <= 1
    assert n_params == sum(np.asarray(x).size for x in jax.tree.leaves(fp))
    model.cast_matmul_weights_()
    assert model.layers[0].mlp.up_proj.weight.dtype == torch.int8
    assert model.embed.weight.dtype == torch.int8
    with pytest.raises(ValueError, match="cannot init"):
        model.init_weights(torch.Generator())
    with pytest.raises(ValueError, match="quantize"):
        port_generate.load_params(cfg, config="tiny", device="cpu", quantize=None, log=lambda m: None)


MOE = dict(n_experts=4, moe_top_k=2, moe_aux_weight=1e-2)


@pytest.fixture(scope="module")
def moe_trees():
    """The MoE llama_tiny tree (sparse dispatch) and its quantize_tree."""
    import flax.linen as nn
    import jax

    jcfg = jax_llama.llama_tiny(moe_dispatch="sparse", **MOE)
    fp = nn.meta.unbox(jax_llama.Llama(jcfg).init(jax.random.key(0), np.zeros((1, PROMPT), np.int32))["params"])
    return jax.device_get(fp), jax.device_get(jax.jit(jax_quant.quantize_tree)(fp))


def test_moe_quantized_tree_carried_bit_for_bit(moe_trees):
    fp, qt = moe_trees
    cfg = port_llama.llama_tiny(quantize="int8", moe_dispatch="sparse", **MOE)
    sd = params_from_jax(qt, cfg)
    E, M, Fd = 4, cfg.d_model, cfg.d_ff
    moe = qt["layers"]["moe_mlp"]
    assert not hasattr(moe["gate"], "q")  # the router stays full precision
    for i in range(cfg.n_layers):
        p = f"layers.{i}.moe_mlp."
        for bank, out in (("w_in", Fd), ("w_out", M)):
            np.testing.assert_array_equal(sd[p + bank].numpy(), np.asarray(moe[bank].q)[i])
            np.testing.assert_array_equal(sd[p + bank + "_scale"].numpy(), np.asarray(moe[bank].scale)[i])
            assert sd[p + bank].dtype == torch.int8 and moe[bank].scale.shape == (cfg.n_layers, E, 1, out)
        np.testing.assert_array_equal(sd[p + "gate"].numpy(), np.asarray(moe["gate"])[i])
        assert sd[p + "gate"].dtype == torch.float32
    assert quant.state_bytes(sd) == jax_quant.tree_bytes(qt)
    # The port's rule on the full-precision tree gives the same entries,
    # shapes and dtypes; its values within the jitted quantizer's one ulp a
    # scale and one level a q (test_quantize_within_one_ulp_of_jitted_quantize).
    mine = quant.quantize_state_dict(params_from_jax(fp, dataclasses.replace(cfg, quantize=None)))
    assert mine.keys() == sd.keys()
    for name, t in sd.items():
        assert mine[name].shape == t.shape and mine[name].dtype == t.dtype, name
        if t.dtype == torch.int8:
            assert (mine[name].int() - t.int()).abs().max() <= 1, name
        else:
            torch.testing.assert_close(mine[name], t, rtol=2e-7, atol=0)
    int8 = port_llama.Llama(cfg)
    int8.load_state_dict(sd)
    assert int8.layers[0].moe_mlp.w_in.dtype == torch.int8


def test_moe_int8_logits_match_jax_int8(moe_trees):
    _, qt = moe_trees
    jcfg = jax_llama.llama_tiny(attn_impl="flash", quantize="int8", moe_dispatch="sparse", **MOE)
    toks = _tokens(2, 16)
    ref = np.asarray(jax_llama.Llama(jcfg).apply({"params": qt}, toks))
    model = _int8_model(qt, moe_dispatch="sparse", **MOE)
    out = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL)
