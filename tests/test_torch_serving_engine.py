"""The port's ServingEngine (pytorch_operator_tpu_torch/serving/engine.py)
against the JAX package's, on the CPU.

``llama_tiny`` in f32; the JAX param tree is built once and carried across
with ``params_from_jax``. Greedy tokens of the port engine must equal the JAX
``ServingEngine``'s token for token (mixed prompt lengths through 3 slots,
and 5 requests through 2 reused slots: chunk 8, block 4, max_decode_len 48),
and each request's single-stream rollout (the port's ``make_generate``), in
full precision and with the int8 stack (int8 weights and int8 KV on one
quantized tree).
Validation messages and the ``stats()`` keys are the JAX engine's. Sampled
tokens are not compared with JAX's: a ``torch.Generator`` cannot reproduce
``jax.random``'s bits.
"""

import dataclasses
import json
import time

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu import faults as jax_faults
from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu.serving import Request as JaxRequest
from pytorch_operator_tpu.serving import ServingEngine as JaxEngine
from pytorch_operator_tpu_torch import faults as port_faults
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.serving import Request, ServingEngine
from pytorch_operator_tpu_torch.workloads import generate as port_generate

L = 48
MIXED = [(5, 7), (13, 9), (8, 3), (21, 5)]
REUSE = [(6, 8), (11, 4), (4, 10), (17, 6), (9, 9)]


@pytest.fixture(scope="module")
def tree():
    import flax.linen as nn
    import jax

    jcfg = jax_llama.llama_tiny(decode=True, max_decode_len=L)
    return jax.device_get(
        nn.meta.unbox(
            jax_llama.Llama(dataclasses.replace(jcfg, decode=False)).init(
                jax.random.key(0), np.zeros((1, 8), np.int32)
            )["params"]
        )
    )


@pytest.fixture(scope="module")
def model(tree):
    cfg = port_llama.llama_tiny(decode=True, max_decode_len=L)
    m, _ = port_generate.load_params(
        cfg, config="tiny", device="cpu", jax_params=tree, log=lambda msg: None
    )
    return m


def _prompts(shapes, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (p,)).astype(np.int32), n) for p, n in shapes]


def _serve(engine, reqs, cls=Request):
    for i, (prompt, n) in enumerate(reqs):
        engine.submit(cls(id=f"r{i}", prompt=prompt, max_new_tokens=n, submit_time=time.time()))
    return {r.id: r for r in engine.run_until_drained()}


def _rollout(model, prompt, new):
    """The port's single-stream rollout (batch 1, uniform cache writes)."""
    gen = port_generate.make_generate(model, max_new_tokens=new)
    cache = port_generate.init_cache(model, 1)
    toks, _ = gen(cache, torch.from_numpy(prompt[None, :]).long(), torch.Generator())
    return toks[0].tolist()


def _engine(model, **kw):
    return ServingEngine(model.cfg, model, chunk=8, block=4, **kw)


@pytest.mark.parametrize(
    "slots,shapes,seed", [(3, MIXED, 0), (2, REUSE, 1)], ids=["mixed_lengths", "slot_reuse"]
)
def test_greedy_tokens_equal_jax_engine(tree, model, slots, shapes, seed):
    reqs = _prompts(shapes, seed)
    jcfg = jax_llama.llama_tiny(decode=True, max_decode_len=L)
    want = _serve(JaxEngine(jcfg, tree, slots=slots, chunk=8, block=4), reqs, JaxRequest)
    got = _serve(_engine(model, slots=slots), reqs)
    assert sorted(got) == sorted(want) == [f"r{i}" for i in range(len(reqs))]
    for i, (prompt, n) in enumerate(reqs):
        rid = f"r{i}"
        assert got[rid].tokens == want[rid].tokens, rid
        assert len(got[rid].tokens) == n
        assert got[rid].tokens == _rollout(model, prompt, n), rid


def test_eos_frees_slot_early(model):
    """A request hitting EOS stops there (EOS kept) and frees its only slot
    for the request queued behind it."""
    (prompt, _), (other, _) = _prompts([(6, 12), (9, 5)], seed=3)
    full = _rollout(model, prompt, 12)
    eos = full[2]
    eng = _engine(model, slots=1, eos_token=eos)
    res = _serve(eng, [(prompt, 12), (other, 5)])
    assert res["r0"].tokens == full[:3] and res["r0"].tokens[-1] == eos
    want = _rollout(model, other, 5)
    cut = want.index(eos) + 1 if eos in want else 5
    assert res["r1"].tokens == want[:cut]
    assert eng.slots_free == 1 and not eng.busy


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_validation_messages_equal_jax(tree, model):
    jcfg = jax_llama.llama_tiny(decode=True, max_decode_len=32)
    pcfg = port_llama.llama_tiny(decode=True, max_decode_len=32)
    jeng = JaxEngine(jcfg, tree, slots=1, chunk=8, block=2)
    peng = ServingEngine(pcfg, model, slots=1, chunk=8, block=2)
    cases = [
        ("big", np.zeros((20,), np.int32), 12),  # 20 + 12 > 31
        ("pad", np.zeros((30,), np.int32), 1),  # fits, but its padded tail (32) does too
        ("empty", np.zeros((0,), np.int32), 4),
        ("zero", np.zeros((4,), np.int32), 0),
        ("neg", np.zeros((4,), np.int32), -5),
    ]
    for rid, prompt, n in cases:
        jr = JaxRequest(id=rid, prompt=prompt, max_new_tokens=n, submit_time=0.0)
        pr = Request(id=rid, prompt=prompt, max_new_tokens=n, submit_time=0.0)
        if rid == "pad":
            jeng.submit(jr)
            peng.submit(pr)
            assert jeng.queued == peng.queued == 1
            continue
        msg = _error(lambda: peng.submit(pr))
        assert msg == _error(lambda: jeng.submit(jr))
    assert "cache budget" in _error(
        lambda: peng.submit(Request("big", np.zeros((20,), np.int32), 12, 0.0))
    )
    for over in ({"decode": False}, {"max_decode_len": 8}):
        msg = _error(lambda: ServingEngine(dataclasses.replace(pcfg, **over), model, slots=1, chunk=8))
        assert msg == _error(lambda: JaxEngine(dataclasses.replace(jcfg, **over), tree, slots=1, chunk=8))
    assert _error(lambda: ServingEngine(pcfg, model, slots=0)) == _error(
        lambda: JaxEngine(jcfg, tree, slots=0)
    )
    assert _error(lambda: ServingEngine(pcfg, model, chunk=8, top_p=0.9)).startswith("top_k/top_p")


def test_stats_keys_and_latency_accounting(tree, model):
    jcfg = jax_llama.llama_tiny(decode=True, max_decode_len=L)
    eng = _engine(model, slots=2)
    assert set(eng.stats()) == set(JaxEngine(jcfg, tree, slots=2, chunk=8).stats())
    assert eng.stats()["decode_tokens_per_sec"] is None
    results = _serve(eng, _prompts([(6, 6)] * 3, seed=4)).values()
    s = eng.stats()
    assert s["requests"] == 3 and s["generated_tokens"] == 18
    assert (s["slots"], s["block"], s["chunk"]) == (2, 4, 8)
    assert s["decode_tokens_per_sec"] > 0
    for k in ("ttft_ms_p50", "ttft_ms_p99", "tpot_ms_p50", "tpot_ms_p99"):
        assert s[k] is not None and s[k] > 0, k
    for r in results:
        assert r.ttft_s >= r.admit_wait_s >= 0
        assert r.tpot_s is not None and r.tpot_s > 0
        assert r.prompt_len == 6
    eng.reset_stats()
    assert eng.stats()["requests"] == 0 and eng.stats()["tpot_ms_p50"] is None


def test_temperature_sampling_serves_and_is_seeded(model):
    reqs = _prompts([(6, 5), (9, 7), (3, 4)], seed=5)

    def tokens(seed):
        eng = _engine(model, slots=2, temperature=1.0, top_k=8, seed=seed)
        return {rid: r.tokens for rid, r in _serve(eng, reqs).items()}

    a = tokens(3)
    assert [len(a[f"r{i}"]) for i in range(3)] == [5, 7, 4]
    assert all(0 <= t < 256 for toks in a.values() for t in toks)
    assert tokens(3) == a


def test_abort_in_flight_evicts_slots_and_keeps_queue(model):
    eng = _engine(model, slots=2)
    for i, (prompt, n) in enumerate(_prompts([(5, 20), (7, 20), (4, 3)], seed=6)):
        eng.submit(Request(f"a{i}", prompt, n, time.time()))
    assert eng.step() == [] and eng.slots_free == 0 and eng.queued == 1
    assert sorted(eng.abort_in_flight()) == ["a0", "a1"]
    assert eng.slots_free == 2 and eng.queued == 1 and eng.busy
    (res,) = eng.run_until_drained()
    assert res.id == "a2" and len(res.tokens) == 3
    assert eng.abort_in_flight() == []


def test_variants_share_weights_and_cache_stays_in_place(model):
    eng = _engine(model, slots=2)
    for name, p in model.named_parameters():
        for variant in (eng._decode_model, eng._prefill_model):
            assert variant.get_parameter(name).data_ptr() == p.data_ptr(), name
    assert eng._decode_model.cfg.decode_per_row and eng._prefill_model.cfg.prefill_mode == "cache"
    ptrs = {
        (layer, k): s.data_ptr()
        for layer, d in eng._cache.items() for k, s in d["attn"].items()
    }
    for i, (prompt, n) in enumerate(_prompts([(9, 6), (17, 5)], seed=7)):
        eng.submit(Request(f"c{i}", prompt, n, time.time()))
    before = eng._cache["layer_0"]["attn"]["cached_key"].clone()
    while eng.busy:
        eng.step()
        assert ptrs == {
            (layer, k): s.data_ptr()
            for layer, d in eng._cache.items() for k, s in d["attn"].items()
        }
    assert not torch.equal(before, eng._cache["layer_0"]["attn"]["cached_key"])


@pytest.mark.parametrize("as_file", [False, True], ids=["inline", "at_path"])
def test_fault_plan_fires_on_the_same_iterations(monkeypatch, tmp_path, as_file):
    """One TPUJOB_FAULT_PLAN: fail_engine_step fires on occurrences
    [nth, nth + times) in both injectors; kinds of other sites are ignored
    here; the port engine's step raises InjectedFault on those iterations."""
    plan = {
        "seed": 1,
        "faults": [
            {"kind": "fail_engine_step", "nth": 2, "times": 2},
            {"kind": "fail_engine_step", "nth": 6},
            {"kind": "crash_at_step", "at": 3},
        ],
    }
    value = json.dumps(plan)
    if as_file:
        (tmp_path / "plan.json").write_text(value)
        value = f"@{tmp_path / 'plan.json'}"
    monkeypatch.setenv("TPUJOB_FAULT_PLAN", value)
    jax_faults.disarm()
    port_faults.reset()
    try:
        def fires(check):
            out = []
            for _ in range(8):
                try:
                    check()
                    out.append(False)
                except Exception as e:  # noqa: BLE001 — each package's InjectedFault
                    assert type(e).__name__ == "InjectedFault"
                    out.append(str(e))
            return out

        want = fires(jax_faults.engine_step_check)
        assert fires(port_faults.engine_step_check) == want
        assert [bool(x) for x in want] == [False, True, True, False, False, True, False, False]
        port_faults.reset()
        eng = ServingEngine(port_llama.llama_tiny(decode=True, max_decode_len=L), _tiny_model(), slots=1, chunk=8, block=2)
        eng.submit(Request("f", np.arange(4, dtype=np.int32), 8, time.time()))
        eng.step()
        with pytest.raises(port_faults.InjectedFault, match="fail_engine_step"):
            eng.step()
    finally:
        jax_faults.disarm()
        port_faults.reset()


def test_bad_fault_plan_is_refused(monkeypatch):
    monkeypatch.setenv("TPUJOB_FAULT_PLAN", json.dumps({"faults": [{"kind": "fail_engine_stp"}]}))
    port_faults.reset()
    try:
        with pytest.raises(ValueError, match="unknown fault kind"):
            port_faults.engine_step_check()
    finally:
        port_faults.reset()


def _tiny_model():
    cfg = port_llama.llama_tiny(decode=True, max_decode_len=L)
    m, _ = port_generate.load_params(cfg, config="tiny", device="cpu", seed=0, log=lambda msg: None)
    return m


def test_engine_positions_pass_the_debug_checks(model, monkeypatch):
    """With TPUJOB_DEBUG_CHECKS on, the engine's ragged per-row decode
    positions and nonzero chunk starts satisfy the decode-position asserts,
    and the tokens are those of the unchecked run."""
    reqs = _prompts(REUSE, seed=1)
    want = {rid: r.tokens for rid, r in _serve(_engine(model, slots=2), reqs).items()}
    monkeypatch.setenv("TPUJOB_DEBUG_CHECKS", "1")
    got = {rid: r.tokens for rid, r in _serve(_engine(model, slots=2), reqs).items()}
    assert got == want


def test_int8_stack_composes(tree):
    """The serving stack's production config, int8 weights and int8 KV,
    through the engine (tests/test_serving_engine.py's test of this name):
    the port engine's tokens equal the JAX engine's and the single-stream
    rollout's on the same quantized tree (``jax.jit(quantize_tree)``, as the
    JAX load_params makes it, carried across bit for bit). The engine's two
    variants share the int8 weights and their scales."""
    import jax

    from pytorch_operator_tpu.ops.quantize import quantize_tree

    qtree = jax.device_get(jax.jit(quantize_tree)(tree))
    over = dict(decode=True, max_decode_len=L, quantize="int8", kv_quantize="int8")
    jcfg = jax_llama.llama_tiny(**over)
    cfg = port_llama.llama_tiny(**over)
    model, _ = port_generate.load_params(
        cfg, config="tiny", device="cpu", jax_params=qtree, quantize="int8", log=lambda msg: None
    )
    reqs = _prompts([(7, 6), (12, 8), (5, 4)], seed=2)
    want = _serve(JaxEngine(jcfg, qtree, slots=2, chunk=8, block=4), reqs, JaxRequest)
    eng = _engine(model, slots=2)
    got = _serve(eng, reqs)
    assert sorted(got) == sorted(want) == ["r0", "r1", "r2"]
    for i, (prompt, n) in enumerate(reqs):
        rid = f"r{i}"
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].tokens == _rollout(model, prompt, n), rid
    layer = eng._cache["layer_0"]["attn"]
    assert layer["cached_key"].dtype == torch.int8 and layer["key_scale"].shape == (2, 2, L, 1)
    for name, t in model.state_dict().items():
        for variant in (eng._decode_model, eng._prefill_model):
            assert variant.state_dict()[name].data_ptr() == t.data_ptr(), name
