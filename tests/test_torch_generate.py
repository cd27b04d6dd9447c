"""The port's generate workload (pytorch_operator_tpu_torch/workloads/generate.py)
against the JAX package's, on the CPU.

Greedy rollouts from the same weights (a JAX param tree through
``params_from_jax``) must be identical token for token. The sampling cases
mirror tests/test_generate.py on the port: the cache-overflow guard, top-k=1
equals greedy, top-p and top-k keep draws inside their support, bad knobs are
refused. Sampled tokens are not compared with JAX's: a ``torch.Generator``
cannot reproduce ``jax.random``'s bits. The int8 flags (``--quantize``,
``--kv-quantize``, ``--init-host``, ``--compare-unquantized``) report JAX's
result keys and are refused where JAX refuses them, with its messages.
"""

import dataclasses
import json

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu.workloads import generate as jax_generate
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.workloads import generate as port_generate

PROMPT, NEW = 8, 8


@pytest.fixture(scope="module")
def setup():
    import flax.linen as nn
    import jax

    jcfg = jax_llama.llama_tiny(decode=True, max_decode_len=PROMPT + NEW)
    tree = jax.device_get(
        nn.meta.unbox(
            jax_llama.Llama(dataclasses.replace(jcfg, decode=False)).init(
                jax.random.key(0), np.zeros((1, PROMPT), np.int32)
            )["params"]
        )
    )
    prompt = np.random.default_rng(1).integers(0, 256, (2, PROMPT)).astype(np.int32)
    return jcfg, tree, prompt


def _port(tree, **over):
    cfg = port_llama.llama_tiny(decode=True, max_decode_len=PROMPT + NEW, **over)
    model, _ = port_generate.load_params(
        cfg, config="tiny", device="cpu", jax_params=tree, log=lambda m: None
    )
    return model


def _rollout(model, prompt, seed=0, **knobs):
    gen = port_generate.make_generate(model, max_new_tokens=NEW, **knobs)
    cache = port_generate.init_cache(model, prompt.shape[0], prompt.shape[1])
    toks, _ = gen(cache, torch.from_numpy(prompt).long(), torch.Generator().manual_seed(seed))
    return toks.numpy()


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_greedy_tokens_equal_jax(setup, attn_impl):
    import jax

    jcfg, tree, prompt = setup
    jmodel = jax_llama.Llama(jcfg)
    ref, _ = jax_generate.make_generate(jmodel, max_new_tokens=NEW)(
        tree, jax_generate.init_cache(jmodel, 2, PROMPT), prompt, jax.random.key(0)
    )
    toks = _rollout(_port(tree, attn_impl=attn_impl), prompt)
    assert toks.shape == (2, NEW)
    np.testing.assert_array_equal(toks, np.asarray(ref))


def test_cache_overflow_rejected(setup):
    _, tree, prompt = setup
    model = _port(tree)
    gen = port_generate.make_generate(model, max_new_tokens=NEW + 1)
    with pytest.raises(ValueError, match="max_decode_len"):
        gen(port_generate.init_cache(model, 2), torch.from_numpy(prompt).long(),
            torch.Generator())


def test_temperature_sampling_runs_and_differs(setup):
    _, tree, prompt = setup
    model = _port(tree)
    hot = _rollout(model, prompt, temperature=5.0)
    assert hot.shape == (2, NEW) and ((hot >= 0) & (hot < 256)).all()
    assert (hot != _rollout(model, prompt)).any()


def test_top_k_one_equals_greedy(setup):
    _, tree, prompt = setup
    model = _port(tree)
    np.testing.assert_array_equal(
        _rollout(model, prompt, temperature=2.0, top_k=1), _rollout(model, prompt)
    )


def test_top_k_and_top_p_restrict_samples(setup):
    _, tree, prompt = setup
    model = _port(tree)
    # top_p -> 0 keeps only the top token: equals greedy.
    np.testing.assert_array_equal(
        _rollout(model, prompt, seed=1, temperature=3.0, top_p=1e-6),
        _rollout(model, prompt),
    )
    with pytest.raises(ValueError, match="top_p"):
        port_generate.make_generate(model, max_new_tokens=NEW, top_p=0.0)
    with pytest.raises(ValueError, match="top_k"):
        port_generate.make_generate(model, max_new_tokens=NEW, top_k=-1)
    with pytest.raises(ValueError, match="temperature"):
        port_generate.make_generate(model, max_new_tokens=NEW, top_p=0.9)


def test_top_k_draws_stay_in_top_k():
    """Every draw under top_k=3 is one of the row's 3 highest logits."""
    from pytorch_operator_tpu_torch.ops.sampling import make_sampler

    logits = torch.from_numpy(np.random.default_rng(4).standard_normal((64, 50)).astype(np.float32))
    top3 = torch.topk(logits, 3, dim=-1).indices
    sample = make_sampler(temperature=10.0, top_k=3)
    g = torch.Generator().manual_seed(0)
    for _ in range(5):
        tok = sample(logits, g)
        assert (tok[:, None] == top3).any(dim=-1).all()


def test_top_p_near_one_composed_with_top_k_stays_in_range(setup):
    _, tree, prompt = setup
    toks = _rollout(_port(tree), prompt, seed=3, temperature=1.0, top_k=4, top_p=1.0 - 1e-12)
    assert toks.shape == (2, NEW) and ((toks >= 0) & (toks < 256)).all()


def test_run_cpu_reports_result_keys():
    """run() on an explicit CPU device: the JAX result keys plus prefill_s and
    the flash launch count (0: the CPU path runs the plain version)."""
    r = port_generate.run(
        config="tiny", batch_size=2, prompt_len=8, max_new_tokens=4,
        device="cpu", log=lambda m: None,
    )
    for key in ("metric", "value", "unit", "config", "params_m", "batch",
                "prompt_len", "max_new_tokens", "max_decode_len", "devices"):
        assert key in r
    assert r["prefill_s"] > 0 and r["flash_launches_per_generate"] == 0
    assert r["device"] == "cpu"


def test_main_int8_flags_report_weight_mb_and_speedup(setup, capsys):
    """The four int8 flags on the CLI: the JAX result keys, ``weight_mb`` the
    JAX package's ``tree_bytes`` of the quantized tree, ``int8_speedup`` the
    control's time over the int8 time of the same call."""
    from pytorch_operator_tpu.ops.quantize import quantize_tree, tree_bytes

    _, tree, _ = setup
    args = ["--config", "tiny", "--device", "cpu", "--batch-size", "2", "--prompt-len", "8",
            "--max-new-tokens", "4", "--json"]
    assert port_generate.main(args + ["--quantize", "int8", "--kv-quantize", "int8",
                                      "--compare-unquantized"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (r["quantize"], r["kv_quantize"]) == ("int8", "int8")
    assert r["weight_mb"] == round(tree_bytes(quantize_tree(tree)) / 1e6, 2)
    assert r["int8_speedup"] == round(r["generate_s_unquantized"] / r["generate_s"], 3)
    assert r["tokens_per_sec_per_chip_unquantized"] > 0 and r["value"] > 0
    assert port_generate.main(args + ["--quantize", "int8", "--init-host"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["quantize"] == "int8" and "int8_speedup" not in r and "kv_quantize" not in r


@pytest.mark.parametrize(
    "kw",
    [dict(init_host=True), dict(compare_unquantized=True),
     dict(quantize="int8", init_host=True, compare_unquantized=True)],
    ids=["init_host_alone", "compare_alone", "compare_with_init_host"],
)
def test_run_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as want:
        jax_generate.run(config="tiny", prompt_len=4, max_new_tokens=2, log=lambda m: None, **kw)
    with pytest.raises(ValueError) as got:
        port_generate.run(config="tiny", prompt_len=4, max_new_tokens=2, device="cpu",
                          log=lambda m: None, **kw)
    assert str(got.value) == str(want.value)
    assert str(got.value) in ("init_host requires quantize='int8'",
                              "compare_unquantized requires quantize and not init_host")


def test_init_host_keeps_only_int8_state(setup):
    """``init_host``: initialised and quantized on the CPU; the model holds
    int8 weights and f32 scales (and f32 norms), the control is refused.
    One seed gives the same int8 state with and without the flag, as
    ``jax.random`` does for the reference."""
    cfg = port_llama.llama_tiny(decode=True, max_decode_len=16, quantize="int8")
    model, n_params = port_generate.load_params(
        cfg, config="tiny", device="cpu", quantize="int8", init_host=True, seed=3, log=lambda m: None
    )
    dtypes = {t.dtype for n, t in model.state_dict().items() if not n.endswith("norm.weight")}
    assert dtypes == {torch.int8, torch.float32}
    assert model.layers[0].attn.q_proj.weight.dtype == torch.int8
    fp, _ = port_generate.load_params(
        dataclasses.replace(cfg, quantize=None), config="tiny", device="cpu", log=lambda m: None
    )
    assert n_params == sum(p.numel() for p in fp.parameters())
    direct, _ = port_generate.load_params(
        cfg, config="tiny", device="cpu", quantize="int8", seed=3, log=lambda m: None
    )
    want = direct.state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert torch.equal(t, want[name]), name
