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

import json
from pathlib import Path

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
    new_keys = {"step_s", "losses", "peak_mem_bytes", "flash_launches_per_step", "device",
                "optimizer", "optimizer_state_bytes", "param_bytes", "world", "mesh", "backend",
                "per_rank"}
    assert set(r) == jax_keys | new_keys
    assert (r["world"], r["mesh"], r["backend"]) == (1, {"fsdp": 1}, None)
    assert r["metric"] == "llama_train_tokens_per_sec_per_chip" and r["end_step"] == 21
    assert len(r["losses"]) == 21 and all(np.isfinite(r["losses"]))
    # ln(256) ≈ 5.55 is chance level on the synthetic bigram stream.
    assert r["final_loss"] < 5.0 and r["losses"][-1] < r["losses"][0]
    assert r["peak_mem_bytes"] is None and r["device"] == "cpu"
    assert r["flash_launches_per_step"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    # AdamW's state: two f32 moments and a step scalar a parameter.
    n = sum(p.numel() for p in port_llama.Llama(port_llama.llama_tiny()).parameters())
    n_tensors = len(list(port_llama.Llama(port_llama.llama_tiny()).parameters()))
    assert r["optimizer"] == "adamw" and r["optimizer_state_bytes"] == 8 * n + 4 * n_tensors


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
        ["--pp-schedule", "1f1b"],
        ["--mesh", "sp=2"],
        ["--attn-impl", "ring"],
    ],
    ids=lambda a: a[0].lstrip("-"),
)
def test_main_refuses_unported_flags(argv):
    """What waits for items 3c-2 and 3c-3 is refused by name: the pipeline
    flags, a mesh axis beyond dp/fsdp/tp (before its size is resolved), ring
    attention."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*3c"):
        llama_train.main(["--device", "cpu", "--steps", "1", "--seq-len", "8", *argv])


def test_only_multi_gpu_flags_are_refused():
    """``--mesh`` is accepted now; only the pipeline flags are refused."""
    assert set(llama_train.REFUSED_FLAGS) == {"--pp-microbatches", "--pp-schedule"}


@pytest.mark.parametrize(
    "argv,check",
    [
        (["--async-checkpoint", "--checkpoint-every", "1"], "async"),
        (["--prefetch", "2"], "prefetch"),
        (["--prefetch", "2", "--prefetch-depth-max", "6", "--feed-autotune",
          "--prefetch-workers", "2"], "prefetch"),
        (["--profile-dir", "prof"], "profile"),
        (["--preempt-at", "100"], "preempt"),
        (["--preempt-at", "1", "--preempt-index", "3"], "preempt"),
        (["--optimizer", "adafactor"], "adafactor"),
    ],
    ids=["async-checkpoint", "prefetch", "prefetch-tuned", "profile-dir", "preempt-at",
         "preempt-index", "optimizer"],
)
def test_main_accepts_the_slice8_flags(argv, check, tmp_path, monkeypatch, capsys):
    """The flags this package used to refuse by name run the tiny config for
    2 steps on the CPU (the preemption cases on a replica it spares: a step
    past the run, or another replica index)."""
    import json

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", str(tmp_path / "ck"))
    monkeypatch.setenv("TPUJOB_REPLICA_INDEX", "0")
    assert llama_train.main([
        "--device", "cpu", "--batch-size", "4", "--seq-len", "16", "--steps", "2",
        "--warmup", "1", "--json", *argv,
    ]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["end_step"] == 3 and len(r["losses"]) == 3
    if check == "async":
        assert len(r["save_s"]) == 2
        assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
            "2", "2.digest", "3", "3.digest",
        ]
    elif check == "prefetch":
        assert r["feed"]["gets"] == 3
    elif check == "profile":
        assert list((tmp_path / "prof").glob("*.pt.trace.json"))
    elif check == "adafactor":
        assert r["optimizer"] == "adafactor" and r["optimizer_state_bytes"] > 0


def test_main_without_cpu_request_needs_a_gpu(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the no-fallback path is not reachable")
    monkeypatch.delenv("TPUJOB_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama_train.main(["--steps", "1", "--seq-len", "8"])
    monkeypatch.setenv("TPUJOB_PLATFORM", "cpu")
    assert llama_train.main(["--steps", "1", "--warmup", "1", "--seq-len", "8", "--json"]) == 0
    assert '"metric": "llama_train_tokens_per_sec_per_chip"' in capsys.readouterr().out


# ---- slice 7: remat, data and eval files, checkpoint and resume ----


IMPLS = {
    "flash_chunked": dict(attn_impl="flash", xent_impl="chunked"),
    "dense": dict(attn_impl="dense", xent_impl="dense"),
    "moe_dense": dict(attn_impl="flash", xent_impl="chunked", n_experts=4, moe_aux_weight=1e-2),
    "moe_sparse": dict(attn_impl="flash", xent_impl="chunked", n_experts=4, moe_aux_weight=1e-2,
                       moe_dispatch="sparse"),
}


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_remat_loss_and_gradients_equal_no_remat(policy, impl):
    """Each block under torch.utils.checkpoint recomputes the same
    arithmetic in the same order on the CPU: the loss and every gradient
    are bit-equal to the run without remat. With MoE the loss includes the
    aux term, which leaves each block through its return value."""
    toks = torch.from_numpy(_batch(0)).long()
    out = []
    for remat in (False, True):
        cfg = port_llama.llama_tiny(remat=remat, remat_policy=policy, **IMPLS[impl])
        model = port_llama.Llama(cfg).init_weights(torch.Generator().manual_seed(0))
        loss = trainer.make_lm_loss_fn(model)(toks)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[n], g1[n]) for n in g0)


def test_dots_policy_saves_gemm_outputs_only():
    """The ``dots`` policy keeps ``aten.mm``/``addmm`` outputs and nothing
    else; ``full`` has no context; an unknown policy raises."""
    from torch.utils.checkpoint import CheckpointPolicy

    from pytorch_operator_tpu_torch.models import common

    assert common.remat_policy(port_llama.llama_tiny(remat=True)) is None
    aten = torch.ops.aten
    assert common._save_dots(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert common._save_dots(None, aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.mul.Tensor, aten.silu.default, aten._to_copy.default):
        assert common._save_dots(None, op) == CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError, match="remat_policy"):
        port_llama.llama_tiny(remat=True, remat_policy="attn")


def test_dots_saves_the_moe_products_jax_saves():
    """JAX's ``dots_with_no_batch_dims_saveable`` saves the router's product
    and the dense dispatch's ``nd,edf->enf`` (no batch dims) and recomputes
    the batched ones (``enf,efd->end``, ``end,ne->nd``, the sparse path's
    four). The port writes the first kind as ``mm`` and the rest as ``bmm``,
    so its ``dots`` policy saves the same products. The dense layer runs two
    router products (the aux loss's and the gates'), then the expert GEMM."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from pytorch_operator_tpu_torch.models import common

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                saved = common._save_dots(None, func) == common.CheckpointPolicy.MUST_SAVE
                self.seen.append((func.__name__.split(".")[0], tuple(args[1].shape), saved))
            return func(*args, **(kwargs or {}))

    E, D, Fd = 4, 64, 128
    for dispatch, want in (
        ("dense", [("mm", (D, E), True), ("mm", (D, E), True), ("mm", (D, E * Fd), True),
                   ("bmm", (E, Fd, D), False), ("bmm", (8, E, D), False)]),
        ("sparse", [("mm", (D, E), True), ("mm", (D, E), True), ("bmm", (1, 8, D), False),
                    ("bmm", (E, D, Fd), False), ("bmm", (E, Fd, D), False),
                    ("bmm", (1, E * 5, D), False)]),
    ):
        cfg = port_llama.llama_tiny(n_experts=E, moe_aux_weight=1e-2, moe_dispatch=dispatch)
        mlp = port_llama.MoEMLP(cfg)
        with torch.no_grad():
            for w in (mlp.gate, mlp.w_in, mlp.w_out):
                w.normal_()
        with Products() as prods:
            mlp(torch.randn(1, 8, D), want_aux=True)
        assert prods.seen == want, (dispatch, prods.seen)


def _pack_tokens(path, toks):
    from pytorch_operator_tpu_torch.data import pack_arrays

    pack_arrays(path, {"tokens": toks})
    return str(path)


@pytest.fixture
def token_files(tmp_path):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (40, 32)).astype(np.int32)
    return _pack_tokens(tmp_path / "train.bin", toks), _pack_tokens(tmp_path / "eval.bin", toks[:16])


def test_data_and_eval_files_match_jax_run(tmp_path):
    """``llama_train.run`` on a packed file with a held-out file, from the
    JAX run's own init (key 0) carried across: the same batches (both
    packages' native loaders, seed 0 and 1) give the same final loss and
    eval loss, within the tolerance of the three-step case."""
    import flax.linen as nn
    import jax

    from pytorch_operator_tpu.workloads import llama_train as jax_llama_train

    # Records one token wider than seq_len, so that the JAX loop copies each
    # batch out of the loader's slot: at full width its slice is a view,
    # which jax.device_put on the CPU aliases while the loader's thread
    # refills the slot, and its losses then depend on timing.
    toks = np.random.default_rng(0).integers(0, 256, (40, 33)).astype(np.int32)
    train_f = _pack_tokens(tmp_path / "train.bin", toks)
    eval_f = _pack_tokens(tmp_path / "eval.bin", toks[:16])
    kw = dict(
        config="tiny", batch_size=8, seq_len=32, steps=3, warmup=1, lr=1e-3,
        lr_schedule="cosine", lr_warmup_steps=1, grad_clip=1.0, data_file=train_f,
        eval_file=eval_f, eval_batches=2, log=lambda m: None,
    )
    want = jax_llama_train.run(**kw)
    init = nn.meta.unbox(
        jax_llama.Llama(jax_llama.llama_tiny()).init(jax.random.key(0), np.zeros((1, 32), np.int32))
    )["params"]
    got = llama_train.run(device="cpu", init_params=jax.device_get(init), **kw)
    assert got["loader"] == "native" and got["end_step"] == want["end_step"] == 4
    np.testing.assert_allclose(
        [got["final_loss"], got["eval_loss"], got["eval_perplexity"]],
        [want["final_loss"], want["eval_loss"], want["eval_perplexity"]], rtol=1e-4,
    )
    assert got["eval_loss"] < got["losses"][0]


def test_resume_after_max_steps_is_bit_equal_to_an_uninterrupted_run(token_files, tmp_path, monkeypatch):
    """Stopped by ``max_steps`` at a checkpoint, then resumed (weights, AdamW
    moments and count restored, the data stream fast-forwarded): the second
    life's losses and the final checkpoint equal an uninterrupted run's bit
    for bit."""
    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager

    train_f, _ = token_files
    kw = dict(
        config="tiny", batch_size=8, seq_len=32, warmup=1, steps=5, lr=1e-3,
        lr_schedule="cosine", lr_warmup_steps=1, lr_decay_steps=6, grad_clip=1.0,
        data_file=train_f, checkpoint_every=3, device="cpu", log=lambda m: None,
    )
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", str(tmp_path / "whole"))
    whole = llama_train.run(max_steps=6, **kw)
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", str(tmp_path / "split"))
    first = llama_train.run(max_steps=3, **kw)
    logs = []
    second = llama_train.run(max_steps=6, **{**kw, "log": logs.append})
    assert (whole["end_step"], first["end_step"], second["end_step"]) == (6, 3, 6)
    assert any("resumed from checkpoint at step 3" in m for m in logs)
    assert any("fast-forwarded 3 batches" in m for m in logs)
    assert first["losses"] == whole["losses"][:3] and second["losses"] == whole["losses"][3:]
    a = CheckpointManager(tmp_path / "whole", create=False)
    b = CheckpointManager(tmp_path / "split", create=False)
    assert a.all_steps() == b.all_steps() == [3, 6]
    like = {"params": {}, "opt_state": {}}
    sa, sb = a.restore(like), b.restore(like)
    for name, t in sa["params"].items():
        assert torch.equal(sb["params"][name], t), name
    assert sa["opt_state"]["count"] == sb["opt_state"]["count"] == 6
    for i, st in sa["opt_state"]["adamw"]["state"].items():
        for key, t in st.items():
            assert torch.equal(sb["opt_state"]["adamw"]["state"][i][key], t), (i, key)


@pytest.mark.parametrize("bad", [256, -1])
@pytest.mark.parametrize("flag", ["data_file", "eval_file"])
def test_out_of_range_token_ids_are_refused_before_training(tmp_path, monkeypatch, bad, flag):
    toks = np.random.default_rng(0).integers(0, 256, (16, 16)).astype(np.int32)
    good = _pack_tokens(tmp_path / "good.bin", toks)
    toks[11, 5] = bad  # one id outside [0, 256), deep in the file
    wrong = _pack_tokens(tmp_path / "bad.bin", toks)
    monkeypatch.setattr(
        llama_train, "throughput_loop", lambda *a, **k: pytest.fail("training ran")
    )
    files = {"data_file": good, "eval_file": good, flag: wrong}
    with pytest.raises(ValueError, match=r"outside the model vocab \[0, 256\)"):
        llama_train.run(
            config="tiny", batch_size=4, seq_len=16, steps=1, device="cpu",
            log=lambda m: None, **files,
        )


def test_main_accepts_the_ported_flags(token_files, tmp_path, monkeypatch, capsys):
    import json

    train_f, eval_f = token_files
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", str(tmp_path / "ck"))
    assert llama_train.main([
        "--device", "cpu", "--batch-size", "8", "--seq-len", "32", "--steps", "2",
        "--warmup", "1", "--data-file", train_f, "--eval-file", eval_f, "--eval-batches", "1",
        "--checkpoint-every", "2", "--max-steps", "3", "--remat", "--remat-policy", "dots",
        "--donate", "--json",
    ]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["end_step"] == 3 and r["loader"] == "native" and "eval_loss" in r
    assert r["donate"] == "no-op (torch has no buffer donation)"
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["2", "2.digest", "3", "3.digest"]
    with pytest.raises(ValueError, match="no effect without --remat"):
        llama_train.main(["--device", "cpu", "--steps", "1", "--remat-policy", "dots"])


def test_port_training_job_resumes_under_the_supervisor(token_files, tmp_path):
    """A port llama_train job under the unchanged supervisor: with
    ``--checkpoint-every`` it saves into the directory the supervisor
    injects, the reconciler's own probe (``_latest_verified_step``, the JAX
    package's ``integrity.latest_verified_step``) reads the port's steps, and
    the job deleted and submitted again resumes from them."""
    from pytorch_operator_tpu.api import ProcessTemplate, ReplicaType, Resources
    from pytorch_operator_tpu.controller import Supervisor
    from pytorch_operator_tpu.controller.store import job_key
    from tests.testutil import new_job

    train_f, eval_f = token_files
    sup = Supervisor(state_dir=tmp_path / "state", poll_interval=0.1)
    log_path = tmp_path / "state" / "logs" / "default_llama-data-torch-master-0.log"
    ends = []
    try:
        for max_steps in (4, 6):
            job = new_job(name="llama-data-torch", workers=0)
            job.spec.port = None
            job.spec.replica_specs[ReplicaType.MASTER].template = ProcessTemplate(
                module="pytorch_operator_tpu_torch.workloads.llama_train",
                args=[
                    "--config", "tiny", "--batch-size", "8", "--seq-len", "32", "--steps", "10",
                    "--warmup", "1", "--data-file", train_f, "--eval-file", eval_f,
                    "--eval-batches", "1", "--checkpoint-every", "2", "--max-steps",
                    str(max_steps), "--remat", "--json",
                ],
                resources=Resources(cpu_devices=1),
            )
            done = sup.run(job, timeout=240)
            log = log_path.read_text()
            assert done.is_succeeded(), f"log:\n{log[-3000:]}"
            key = job_key(done)
            ends.append(sup.reconciler._latest_verified_step(key))
            # Job-level resume: delete the job (its checkpoints stay) and
            # submit the spec again.
            sup.delete_job(key)
        ckpt = Path(sup.reconciler._checkpoint_dir(key))
    finally:
        sup.shutdown()
    assert ends == [4, 6]
    assert "resumed from checkpoint at step 4" in log and "(cpu)" in log
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "2", "2.digest", "4", "4.digest", "6", "6.digest",
    ]


# ---- slice 9: the mixture-of-experts Llama ----


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_moe_run_matches_jax_run(dispatch):
    """``llama_train.run --experts 4`` (top 2, aux 1e-2, AdamW) from the JAX
    run's own init (key 0): the same final loss after three steps within
    rtol 1e-4, and the same parameter counts (``active_params_m``: the
    non-expert parameters plus top_k/E of the banks for sparse, all of them
    for dense)."""
    import flax.linen as nn
    import jax

    from pytorch_operator_tpu.workloads import llama_train as jax_llama_train

    moe = dict(n_experts=4, moe_top_k=2, moe_dispatch=dispatch, moe_aux_weight=1e-2)
    kw = dict(config="tiny", batch_size=8, seq_len=32, steps=2, warmup=1, lr=1e-3,
              log=lambda m: None, **moe)
    want = jax_llama_train.run(**kw)
    init = nn.meta.unbox(
        jax_llama.Llama(jax_llama.llama_tiny(**moe)).init(jax.random.key(0), np.zeros((1, 32), np.int32))
    )["params"]
    got = llama_train.run(device="cpu", init_params=jax.device_get(init), **kw)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-4)
    for key in ("params_m", "active_params_m", "n_experts", "moe_dispatch", "end_step"):
        assert got[key] == want[key], key
    if dispatch == "sparse":
        assert got["active_params_m"] < got["params_m"]
    else:
        assert got["active_params_m"] == got["params_m"]
    aux = got["aux_losses"]
    assert len(aux) == len(got["losses"]) == 3 and all(1.0 <= a < 1.5 for a in aux)


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_moe_aux_gradient_matches_jax(dispatch):
    """At aux weight 1.0 the load-balance term is a fifth of the loss and
    its gradient moves the router: two AdamW steps' losses within rtol 1e-4
    and every parameter after the first within atol 3e-5, as in the dense
    three-step case."""
    over = dict(attn_impl="flash", xent_impl="chunked", n_experts=4, moe_dispatch=dispatch,
                moe_aux_weight=1.0)
    jl, pl, after1 = _run_both(over, {}, 2)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    _assert_params_close(after1)


def test_main_moe_flags_and_checks(monkeypatch, capsys):
    """The MoE flags reach run(): the result carries the MoE keys; the
    reference's checks raise (top-k outside [1, E], aux weight without
    experts) and its warning for sparse dispatch without aux is logged."""
    monkeypatch.setenv("TPUJOB_PLATFORM", "cpu")
    base = ["--steps", "1", "--warmup", "1", "--seq-len", "16", "--batch-size", "2"]
    with pytest.warns(UserWarning, match="moe_aux_weight=0"):
        assert llama_train.main([*base, "--experts", "4", "--moe-dispatch", "sparse",
                                 "--moe-capacity-factor", "2", "--moe-top-k", "1", "--json"]) == 0
    out = capsys.readouterr().out
    assert "WARNING: --moe-dispatch sparse with no --moe-aux-weight" in out
    assert "every expert runs on this one card" in out
    result = json.loads(out.strip().splitlines()[-1])
    assert result["n_experts"] == 4 and result["moe_dispatch"] == "sparse"
    assert "aux_losses" not in result
    for argv, match in (
        (["--experts", "4", "--moe-top-k", "5"], "moe_top_k=5 must lie in"),
        (["--experts", "4", "--moe-top-k", "0"], "moe_top_k=0 must lie in"),
        (["--moe-aux-weight", "1e-2"], "needs a MoE model"),
    ):
        with pytest.raises(ValueError, match=match):
            llama_train.main([*base, *argv])
