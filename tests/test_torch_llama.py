"""The port's Llama (pytorch_operator_tpu_torch/models/llama.py) against the
JAX package's, on the same weights, on the CPU.

The JAX param tree goes through ``convert.params_from_jax``; inputs are made
from a numpy seed. ``llama_tiny`` in f32 with ``attn_impl="flash"`` (the JAX
kernel in pallas interpret mode, the port's plain version): full-forward
logits, and the serving path — a prefill plus three decode steps through
``decode_forward`` — for the uniform and per-row cache writes and for a
chunked (``prefill_mode="cache"``) prefill, comparing hidden states and the
returned cache slabs.

Tolerance 1e-4: both sides compute in f32 and differ only in the order of
their sums (matmuls, softmax, rotary), over two layers at unit scale.

The mixture-of-experts Llama (4 experts, top 2, dense and sparse dispatch,
aux weight 1e-2): logits within 1e-4 and the aux value (the mean over layers
of the load-balance loss) within rtol 1e-5; ``decode_forward`` over a prefill
and three greedy steps, hidden states within 1e-4 and the greedy tokens
equal; the banks' init against flax's ``lecun_normal``.
"""

import dataclasses

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax

TOL = 1e-4
PROMPT = 8


def _jax_params(cfg):
    import flax.linen as nn
    import jax

    train_cfg = dataclasses.replace(
        cfg, decode=False, decode_per_row=False, prefill_mode="self"
    )
    params = jax_llama.Llama(train_cfg).init(
        jax.random.key(0), np.zeros((1, PROMPT), np.int32)
    )["params"]
    return jax.device_get(nn.meta.unbox(params))


def _port_model(tree, **over):
    cfg = port_llama.llama_tiny(attn_impl="flash", **over)
    model = port_llama.Llama(cfg)
    model.load_state_dict(params_from_jax(tree, cfg))
    return model.requires_grad_(False)


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def test_forward_logits_match():
    cfg = jax_llama.llama_tiny(attn_impl="flash")
    tree = _jax_params(cfg)
    toks = _tokens(2, 16)
    ref = jax_llama.Llama(cfg).apply({"params": tree}, toks)
    model = _port_model(tree)
    out = model(torch.from_numpy(toks).long())
    assert out.dtype == torch.float32 and out.shape == (2, 16, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
    hidden = model(torch.from_numpy(toks).long(), return_hidden=True)
    np.testing.assert_allclose(
        (hidden @ model.head_kernel()).numpy(), np.asarray(ref), atol=TOL
    )


def _check_cache(jc, pc, n_layers):
    for i in range(n_layers):
        for name in ("cached_key", "cached_value"):
            np.testing.assert_allclose(
                pc[f"layer_{i}"]["attn"][name].numpy(),
                np.asarray(jc[f"layer_{i}"]["attn"][name]),
                atol=TOL,
                err_msg=f"layer_{i} {name}",
            )


@pytest.mark.parametrize(
    "per_row,prefill_mode",
    [(False, "self"), (True, "self"), (False, "cache")],
    ids=["uniform", "per_row", "chunked_prefill"],
)
def test_decode_forward_matches(per_row, prefill_mode):
    """Prefill (one shot, or two chunks under prefill_mode="cache"), then
    three single-token steps; per-row steps sit at different depths."""
    B, new = 2, 3
    over = dict(
        decode=True, max_decode_len=PROMPT + new + 1,
        decode_per_row=per_row, prefill_mode=prefill_mode,
    )
    jcfg = jax_llama.llama_tiny(attn_impl="flash", **over)
    tree = _jax_params(jcfg)
    jmodel = jax_llama.Llama(jcfg)
    model = _port_model(tree, **over)
    jcache = jax_llama.init_decode_cache(jcfg, B)
    pcache = port_llama.init_decode_cache(model.cfg, B)

    def step(tokens, positions):
        nonlocal jcache
        jh, jcache = jax_llama.decode_forward(jmodel, tree, jcache, tokens, positions)
        ph, _ = port_llama.decode_forward(
            model, pcache, torch.from_numpy(tokens).long(),
            None if positions is None else torch.from_numpy(positions).long(),
        )
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=TOL)
        return ph

    prompt = _tokens(B, PROMPT)
    if prefill_mode == "cache":
        half = PROMPT // 2
        pos = np.broadcast_to(np.arange(PROMPT, dtype=np.int32), (B, PROMPT))
        step(prompt[:, :half], np.ascontiguousarray(pos[:, :half]))
        step(prompt[:, half:], np.ascontiguousarray(pos[:, half:]))
    else:
        step(prompt, None)
    _check_cache(jcache, pcache, jcfg.n_layers)
    tok = _tokens(B, new, seed=2)
    for i in range(new):
        pos = np.full((B, 1), PROMPT + i, np.int32)
        if per_row:
            pos[1] += 1  # row 1 runs one slot ahead of row 0
        step(tok[:, i : i + 1], pos)
    _check_cache(jcache, pcache, jcfg.n_layers)


def test_config_validation():
    """Same validation as the JAX config: ring and ulysses are accepted for
    training and refused for decoding, as in JAX."""
    with pytest.raises(ValueError, match="prefill_mode"):
        port_llama.llama_tiny(prefill_mode="bogus")
    with pytest.raises(ValueError, match="require decode=True"):
        port_llama.llama_tiny(decode_per_row=True)
    for impl in ("ring", "ulysses"):
        assert port_llama.llama_tiny(attn_impl=impl).attn_impl == impl
        with pytest.raises(ValueError, match="decode=True"):
            port_llama.llama_tiny(attn_impl=impl, decode=True)
    with pytest.raises(ValueError, match="attn_impl"):
        port_llama.llama_tiny(attn_impl="bogus")
    # MoE is ported: the reference's warning for sparse dispatch without the
    # aux loss, and a dispatch name check.
    assert port_llama.llama_tiny(n_experts=4).n_experts == 4
    with pytest.warns(UserWarning, match="moe_aux_weight=0"):
        port_llama.llama_tiny(n_experts=4, moe_dispatch="sparse")
    with pytest.raises(ValueError, match="moe_dispatch"):
        port_llama.llama_tiny(n_experts=4, moe_dispatch="bogus")
    # remat is ported; an unknown policy raises, as in JAX.
    with pytest.raises(ValueError, match="remat_policy"):
        port_llama.llama_tiny(remat=True, remat_policy="bogus")
    cfg = port_llama.llama_0_3b()
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (
        1024, 16, 8, 4, 128,
    )
    assert cfg.attn_impl == "flash" and cfg.dtype == torch.bfloat16


def test_params_from_jax_rejects_wrong_config():
    tree = _jax_params(jax_llama.llama_tiny())
    with pytest.raises(ValueError, match="layers/attn/q_proj/kernel"):
        params_from_jax(tree, port_llama.llama_tiny(n_heads=8, n_kv_heads=2))


def test_f32_params_cast_at_the_call():
    """Parameters in param_dtype (f32), cast to the compute dtype (bf16) at
    the call: the same logits as weights cast once at load (the arithmetic
    is the same, so the logits are bit-equal), close to JAX's flax model
    (param_dtype f32, dtype bf16), and generate's one-time cast gives the
    greedy tokens of the cast-at-call model."""
    from pytorch_operator_tpu_torch.workloads import generate as port_generate

    jcfg = jax_llama.llama_tiny(dtype=jax_llama.jnp.bfloat16)
    tree = _jax_params(jcfg)
    toks = torch.from_numpy(_tokens(2, 16)).long()
    cfg = port_llama.llama_tiny(dtype=torch.bfloat16)

    sd = params_from_jax(tree, cfg)
    assert all(t.dtype == torch.float32 for t in sd.values())
    master = port_llama.Llama(cfg)
    master.load_state_dict(sd)
    assert all(p.dtype == torch.float32 for p in master.parameters())
    cast_once = port_llama.Llama(cfg)
    cast_once.load_state_dict(sd)
    cast_once.cast_matmul_weights_()
    assert cast_once.embed.weight.dtype == torch.bfloat16
    assert cast_once.layers[0].mlp.up_proj.weight.dtype == torch.bfloat16
    assert cast_once.lm_head.weight.dtype == torch.float32
    with torch.no_grad():
        logits = master(toks)
        assert torch.equal(logits, cast_once(toks))
    ref = np.asarray(jax_llama.Llama(jcfg).apply({"params": tree}, toks.numpy()))
    # bf16 activations on both sides, rounded at different places.
    np.testing.assert_allclose(logits.numpy(), ref, atol=5e-2)

    # Gradients reach the f32 master weights through the cast.
    master(toks).sum().backward()
    assert master.layers[0].attn.q_proj.weight.grad.dtype == torch.float32
    assert master.embed.weight.grad.dtype == torch.float32

    dcfg = port_llama.llama_tiny(dtype=torch.bfloat16, decode=True, max_decode_len=16)
    served, _ = port_generate.load_params(
        dcfg, config="tiny", device="cpu", jax_params=tree, log=lambda m: None
    )
    assert served.layers[1].attn.o_proj.weight.dtype == torch.bfloat16
    at_call = port_llama.Llama(dcfg)
    at_call.load_state_dict(params_from_jax(tree, dcfg))
    outs = []
    for model in (served, at_call):
        gen = port_generate.make_generate(model.requires_grad_(False), max_new_tokens=6)
        cache = port_generate.init_cache(model, 2)
        outs.append(gen(cache, toks[:, :8], torch.Generator())[0])
    assert torch.equal(outs[0], outs[1])


class TestDebugChecks:
    """``TPUJOB_DEBUG_CHECKS`` decode-position asserts in ``decode_forward``
    (the four cases of tests/test_serving_batch.py's TestDebugChecks)."""

    @staticmethod
    def _model(**over):
        cfg = port_llama.llama_tiny(decode=True, max_decode_len=16, **over)
        model = port_llama.Llama(cfg).init_weights(torch.Generator().manual_seed(0))
        return model.requires_grad_(False), cfg

    def test_per_row_model_accepts_ragged_positions(self, monkeypatch):
        monkeypatch.setenv("TPUJOB_DEBUG_CHECKS", "1")
        model, cfg = self._model(decode_per_row=True)
        cache = port_llama.init_decode_cache(cfg, 2)
        tok = torch.zeros((2, 1), dtype=torch.long)
        pos = torch.tensor([[3], [7]])  # ragged: fine per-row
        out, _ = port_llama.decode_forward(model, cache, tok, pos)
        assert out.shape == (2, 1, cfg.d_model)
        uniform, _ = self._model()
        with pytest.raises(ValueError, match="batch-uniform"):
            port_llama.decode_forward(uniform, cache, tok, pos)

    def test_overflow_positions_rejected(self, monkeypatch):
        monkeypatch.setenv("TPUJOB_DEBUG_CHECKS", "1")
        model, cfg = self._model(decode_per_row=True)
        cache = port_llama.init_decode_cache(cfg, 2)
        tok = torch.zeros((2, 1), dtype=torch.long)
        pos = torch.tensor([[3], [16]])  # row 1 past the cache
        with pytest.raises(ValueError, match="max_decode_len"):
            port_llama.decode_forward(model, cache, tok, pos)
        with pytest.raises(ValueError, match="contiguous"):
            port_llama.decode_forward(
                model, cache, torch.zeros((2, 2), dtype=torch.long),
                torch.tensor([[3, 5], [7, 8]]),
            )

    def test_self_mode_still_rejects_nonzero_prefill_start(self, monkeypatch):
        monkeypatch.setenv("TPUJOB_DEBUG_CHECKS", "1")
        model, cfg = self._model()
        cache = port_llama.init_decode_cache(cfg, 1)
        toks = torch.zeros((1, 4), dtype=torch.long)
        pos = torch.arange(2, 6)[None, :]
        with pytest.raises(ValueError, match="prefill"):
            port_llama.decode_forward(model, cache, toks, pos)
        monkeypatch.setenv("TPUJOB_DEBUG_CHECKS", "0")
        port_llama.decode_forward(model, cache, toks, pos)  # off: no check

    def test_cache_mode_accepts_nonzero_prefill_start(self, monkeypatch):
        monkeypatch.setenv("TPUJOB_DEBUG_CHECKS", "1")
        model, cfg = self._model(prefill_mode="cache")
        cache = port_llama.init_decode_cache(cfg, 1)
        toks = torch.zeros((1, 4), dtype=torch.long)
        pos = torch.arange(2, 6)[None, :]
        out, _ = port_llama.decode_forward(model, cache, toks, pos)
        assert out.shape == (1, 4, cfg.d_model)


MOE = dict(n_experts=4, moe_top_k=2, moe_aux_weight=1e-2)


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_moe_logits_and_aux_match_jax(dispatch):
    import jax

    jcfg = jax_llama.llama_tiny(attn_impl="flash", moe_dispatch=dispatch, **MOE)
    tree = _jax_params(jcfg)
    assert set(tree["layers"]["moe_mlp"]) == {"gate", "w_in", "w_out"}
    toks = _tokens(2, 16)
    ref, mods = jax_llama.Llama(jcfg).apply({"params": tree}, toks, mutable=["losses"])
    (leaf,) = [np.asarray(a) for a in jax.tree.leaves(mods["losses"])]
    model = _port_model(tree, moe_dispatch=dispatch, **MOE)
    out, aux = model(torch.from_numpy(toks).long(), return_aux=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
    assert leaf.shape == (model.cfg.n_layers,)
    np.testing.assert_allclose(float(aux), leaf.mean(), rtol=1e-5)
    # Without return_aux: the logits alone, no aux computed.
    assert torch.equal(model(torch.from_numpy(toks).long()), out)


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_moe_decode_forward_greedy_matches_jax(dispatch):
    """A prefill and three greedy steps through both decode_forwards: the
    hidden states within TOL, the tokens equal."""
    B, new = 2, 3
    over = dict(decode=True, max_decode_len=PROMPT + new + 1, moe_dispatch=dispatch, **MOE)
    jcfg = jax_llama.llama_tiny(attn_impl="flash", **over)
    tree = _jax_params(jcfg)
    jmodel = jax_llama.Llama(jcfg)
    model = _port_model(tree, **over)
    jcache = jax_llama.init_decode_cache(jcfg, B)
    pcache = port_llama.init_decode_cache(model.cfg, B)
    toks, pos = _tokens(B, PROMPT), None
    head = model.head_kernel()
    chosen = []
    for i in range(new + 1):
        jh, jcache = jax_llama.decode_forward(jmodel, tree, jcache, toks, pos)
        ph, _ = port_llama.decode_forward(
            model, pcache, torch.from_numpy(toks).long(),
            None if pos is None else torch.from_numpy(pos).long(),
        )
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=TOL)
        jtok = np.asarray(jh)[:, -1] @ np.asarray(jax_llama.Llama.head_kernel(tree))
        ptok = (ph[:, -1] @ head).argmax(-1).numpy()
        np.testing.assert_array_equal(ptok, jtok.argmax(-1))
        chosen.append(ptok)
        toks = ptok[:, None].astype(np.int32)
        pos = np.full((B, 1), PROMPT + i, np.int32)
    assert len({tuple(c) for c in chosen}) > 1  # not one token repeated


def test_moe_init_follows_lecun_normal_and_cast_keeps_the_router():
    """flax's lecun_normal counts a bank's expert axis in its fan-in: w_in
    [E, D, F] has std 1/sqrt(E·D) (0.02210 at [8, 256, 1024]), w_out
    1/sqrt(E·F), the router [D, E] 1/sqrt(D). The port's init and flax's
    draws hold those within 2%. cast_matmul_weights_ casts the banks and
    leaves the router in its dtype."""
    import jax

    E, D, Fd = 8, 256, 1024
    cfg = port_llama.llama_tiny(n_experts=E, d_model=D, d_ff=Fd, n_layers=1, n_heads=2,
                                n_kv_heads=1, head_dim=128, dtype=torch.bfloat16)
    model = port_llama.Llama(cfg).init_weights(torch.Generator().manual_seed(0))
    mlp = model.layers[0].moe_mlp
    init = jax.nn.initializers.lecun_normal()
    for name, shape, fan_in in (("w_in", (E, D, Fd), E * D), ("w_out", (E, Fd, D), E * Fd),
                                ("gate", (D, E), D)):
        want = 1 / np.sqrt(fan_in)
        got = getattr(mlp, name).detach()
        assert tuple(got.shape) == shape
        ref = np.asarray(init(jax.random.key(1), shape, np.float32))
        for std in (float(got.float().std()), float(ref.std())):
            assert abs(std / want - 1) < 0.02, (name, std, want)
    assert abs(want - 1 / 16) < 1e-9 and abs(1 / np.sqrt(E * D) - 0.02210) < 1e-5
    model.cast_matmul_weights_()
    assert mlp.w_in.dtype == mlp.w_out.dtype == torch.bfloat16
    assert mlp.gate.dtype == torch.float32
