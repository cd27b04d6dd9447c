"""The port's training path (pytorch_operator_tpu_torch/workloads/{trainer,
llama_train}.py) against the JAX package's, on the CPU.

One JAX ``llama_tiny`` init (f32) is carried into the port with
``params_from_jax`` (which keeps param_dtype, f32); both sides then take the
same AdamW steps on the same bigram batches (JAX: ``make_lm_train_step`` on a
one-device mesh, the flash kernel in pallas interpret mode; the port: the
plain versions of its kernels). Tolerances: per-step losses within rtol 1e-4
(f32 on both sides, sums in another order); every parameter after the first
step within atol 3e-5, a tenth of the learning rate, so that a wrong sign, a
missing bias correction or a missing decay term shows. The three-step case
compares every step's loss; parameters are compared after step 1 only, where
Adam's first update (about lr·sign(g)) has not yet amplified rounding in the
tiny second moments.
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu.workloads import trainer as jax_trainer
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.workloads import llama_train, trainer

B, S, LR = 4, 32, 3e-4


def _jax_setup(cfg_over, opt_over, grad_accum=1):
    import flax.linen as nn
    import jax

    from pytorch_operator_tpu.parallel import make_mesh

    jcfg = jax_llama.llama_tiny(**cfg_over)
    model = jax_llama.Llama(jcfg)
    params = jax.device_get(
        nn.meta.unbox(model.init(jax.random.key(0), np.zeros((1, S), np.int32))["params"])
    )
    tx = jax_trainer.make_optimizer(LR, **opt_over)
    mesh = make_mesh({"fsdp": 1}, devices=jax.devices()[:1])
    step = jax_trainer.make_lm_train_step(model, tx, mesh, grad_accum=grad_accum)
    state = {"params": params, "opt_state": tx.init(params)}
    return params, step, state, mesh


def _port_setup(tree, cfg_over, opt_over, grad_accum=1):
    cfg = port_llama.llama_tiny(**cfg_over)
    model = port_llama.Llama(cfg)
    model.load_state_dict(params_from_jax(tree, cfg))
    opt = trainer.make_optimizer(model.parameters(), LR, **opt_over)
    return model, trainer.make_lm_train_step(model, opt, grad_accum=grad_accum)


def _batch(step):
    return llama_train.synthetic_bigram_batch(B, S, 256, step)


def _run_both(cfg_over, opt_over, n_steps, grad_accum=1):
    """Losses of both sides per step, and both parameter sets after step 1
    (the port's state dict, and JAX's through params_from_jax)."""
    import jax

    tree, jstep, state, mesh = _jax_setup(cfg_over, opt_over, grad_accum)
    model, pstep = _port_setup(tree, cfg_over, opt_over, grad_accum)
    jl, pl, after1 = [], [], None
    for i in range(n_steps):
        toks = _batch(i)
        with mesh:
            state, loss = jstep(state, toks)
        jl.append(float(loss))
        pl.append(float(pstep(torch.from_numpy(toks).long())))
        if i == 0:
            jtree = params_from_jax(jax.device_get(state["params"]), model.cfg)
            after1 = ({k: v.detach().clone() for k, v in model.state_dict().items()}, jtree)
    return np.array(jl), np.array(pl), after1


def _assert_params_close(after1, atol=3e-5):
    port, jax_sd = after1
    assert port.keys() == jax_sd.keys()
    for name, p in port.items():
        np.testing.assert_allclose(p.numpy(), jax_sd[name].numpy(), atol=atol, rtol=0, err_msg=name)


def test_three_adamw_steps_match_jax():
    """The slice as a whole: flash attention + chunked loss + AdamW."""
    over = dict(attn_impl="flash", xent_impl="chunked")
    jl, pl, after1 = _run_both(over, {}, 3)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0]
    _assert_params_close(after1)


def test_cosine_schedule_and_grad_clip_match_jax():
    """Warmup + cosine decay read at the step count before the update, and
    optax's global-norm clip (the tiny model's gradient norm at init is
    above 1, so the clip acts)."""
    opt = dict(schedule="cosine", warmup_steps=2, decay_steps=5, grad_clip=1.0)
    jl, pl, after1 = _run_both({}, opt, 4)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    _assert_params_close(after1)


def test_schedule_values_match_optax():
    import optax

    for warm, decay in ((0, 4), (2, 5), (3, 10)):
        ref = optax.warmup_cosine_decay_schedule(
            0.0, LR, max(warm, 1), max(decay or warm + 1, warm + 1)
        )
        for count in range(12):
            got = trainer.lr_at(count, LR, schedule="cosine", warmup_steps=warm,
                                decay_steps=decay)
            assert got == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12)
    assert trainer.lr_at(7, LR, schedule="constant", warmup_steps=0, decay_steps=None) == LR
    # No decay left after the warmup: optax refuses it, and so does the port.
    with pytest.raises(ValueError, match="decay_steps"):
        optax.warmup_cosine_decay_schedule(0.0, LR, 1, 1)
    with pytest.raises(ValueError, match="decay steps"):
        trainer.make_optimizer([torch.zeros(1, requires_grad=True)], LR, schedule="cosine")


def test_clip_matches_optax_and_has_no_epsilon():
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        got = [torch.from_numpy(g.copy()) for g in grads]
        norm = trainer.clip_by_global_norm_(got, max_norm)
        assert float(norm) == pytest.approx(float(np.sqrt(sum((g**2).sum() for g in grads))))
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


def test_grad_accum_matches_jax_and_unsplit_step():
    jl, pl, after1 = _run_both({}, {}, 2, grad_accum=2)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    _assert_params_close(after1)
    # Port against port: two microbatches equal the unsplit step up to f32
    # reassociation in the sums.
    tree, *_ = _jax_setup({}, {})
    models = []
    for accum in (1, 2):
        model, step = _port_setup(tree, {}, {}, grad_accum=accum)
        loss = float(step(torch.from_numpy(_batch(0)).long()))
        models.append((model, loss))
    (m1, l1), (m2, l2) = models
    assert l2 == pytest.approx(l1, rel=1e-6)
    for (name, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_dense_attention_dense_loss_match_jax():
    over = dict(attn_impl="dense", xent_impl="dense")
    jl, pl, after1 = _run_both(over, {}, 2)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    _assert_params_close(after1)


def test_run_cpu_result_keys_and_loss_falls():
    r = llama_train.run(
        config="tiny", batch_size=8, seq_len=32, steps=20, warmup=1, lr=1e-3,
        device="cpu", log=lambda m: None,
    )
    jax_keys = {"metric", "value", "unit", "config", "params_m", "final_loss",
                "end_step", "devices", "n_layers", "d_model"}
    new_keys = {"step_s", "losses", "peak_mem_bytes", "flash_launches_per_step", "device"}
    assert set(r) == jax_keys | new_keys
    assert r["metric"] == "llama_train_tokens_per_sec_per_chip" and r["end_step"] == 21
    assert len(r["losses"]) == 21 and all(np.isfinite(r["losses"]))
    # ln(256) ≈ 5.55 is chance level on the synthetic bigram stream.
    assert r["final_loss"] < 5.0 and r["losses"][-1] < r["losses"][0]
    assert r["peak_mem_bytes"] is None and r["device"] == "cpu"
    assert r["flash_launches_per_step"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_run_cpu_flash_chunked_and_bf16_params():
    """The llama presets' path (flash + chunked) runs on the CPU with the
    plain versions, also with bf16 parameters."""
    for param_dtype in ("float32", "bfloat16"):
        r = llama_train.run(
            config="tiny", batch_size=2, seq_len=16, steps=2, warmup=1,
            attn_impl="flash", xent_impl="chunked", param_dtype=param_dtype,
            device="cpu", log=lambda m: None,
        )
        assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"]))


@pytest.mark.parametrize(
    "argv",
    [
        ["--remat"],
        ["--checkpoint-every", "5"],
        ["--data-file", "x.bin"],
        ["--mesh", "fsdp=2"],
        ["--profile-dir", "p"],
        ["--preempt-at", "3"],
        ["--attn-impl", "ring"],
        ["--optimizer", "adafactor"],
    ],
    ids=lambda a: a[0].lstrip("-"),
)
def test_main_refuses_unported_flags(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama_train.main(["--device", "cpu", "--steps", "1", "--seq-len", "8", *argv])


def test_main_without_cpu_request_needs_a_gpu(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the no-fallback path is not reachable")
    monkeypatch.delenv("TPUJOB_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama_train.main(["--steps", "1", "--seq-len", "8"])
    monkeypatch.setenv("TPUJOB_PLATFORM", "cpu")
    assert llama_train.main(["--steps", "1", "--warmup", "1", "--seq-len", "8", "--json"]) == 0
    assert '"metric": "llama_train_tokens_per_sec_per_chip"' in capsys.readouterr().out
