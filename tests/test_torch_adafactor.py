"""The port's adafactor (pytorch_operator_tpu_torch/workloads/trainer.py
``Adafactor``) against ``optax.adafactor`` as the JAX package's
``make_optimizer`` builds it, on the CPU.

One JAX init of a tiny Llama wide enough for optax to factor its leaves
(d_model 256, 4 heads and 2 kv heads of 128, d_ff 512: q/k/v are stacked
``[L, M, heads, D]`` leaves factored over M and D, o and the MLP
``[L, in, out]``, the embedding and head ``[V, M]``; the stacked norms
``[L, M]`` are not factored, L < 128)
is carried into the port with ``params_from_jax``; both sides then take the
same steps on the same bigram batches (dense attention and loss on both
sides). Tolerances:

- float32 parameters: every parameter after every step within atol 1e-6 (a
  few ulps of the largest parameter, |p| < 5; an update is ~lr·rms(p), so a
  factored axis or a block RMS taken on another block moves parameters by
  1e-4 or more, as the per-tensor control below shows); the statistics
  within rtol 5e-5 (they are means of g², which doubles the gradients'
  relative differences, ~1e-5 where sums run in another order).
- bfloat16 parameters: each step starts from JAX's parameters and optimizer
  state before it (teacher forcing: both sides compute and round the bf16
  gradients each in their own order, and a free run compounds that from
  step to step). Then the loss within rtol 1e-4 and the norm scales
  (float32 in both packages) within atol 1e-5; each bf16 leaf's update of
  the step within a relative L2 error of 10% of JAX's, with at most 8% of
  its elements not bit-equal. At lr 1e-2 a step moves a bf16 parameter by
  about two of its ulps, so a gradient an ulp apart flips the rounding of
  some elements by half their update (measured: 5.6% and 4.5% at worst,
  1.1e-6 on the norms;
  f32 intermediates instead of bf16 ones change neither).
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu.workloads import trainer as jax_trainer
from pytorch_operator_tpu_torch.models import convert
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.models.convert import params_from_jax
from pytorch_operator_tpu_torch.workloads import llama_train, trainer

B, S, LR = 4, 32, 1e-2
WIDE = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=128, d_ff=512)


def _configs(param_dtype):
    import jax.numpy as jnp

    jover, pover = dict(WIDE), dict(WIDE)
    if param_dtype == "bfloat16":
        jover["param_dtype"] = jnp.bfloat16
        pover["param_dtype"] = torch.bfloat16
    return jax_llama.llama_tiny(**jover), port_llama.llama_tiny(**pover)


def _setup(param_dtype, opt_over, layer1_scale: float = 1.0):
    """Both sides from one JAX init; ``layer1_scale`` multiplies layer 1's
    slice of every stacked leaf (both sides), so that a layer's RMS differs
    from its leaf's."""
    import flax.linen as nn
    import jax

    from pytorch_operator_tpu.parallel import make_mesh

    jcfg, pcfg = _configs(param_dtype)
    jmodel = jax_llama.Llama(jcfg)
    params = jax.device_get(
        nn.meta.unbox(jmodel.init(jax.random.key(0), np.zeros((1, S), np.int32))["params"])
    )
    if layer1_scale != 1.0:

        def scale(path, x):
            if path[0].key != "layers":
                return x
            x = np.array(x)
            x[1] = x[1] * layer1_scale
            return x

        params = jax.tree_util.tree_map_with_path(scale, params)
    tx = jax_trainer.make_optimizer(LR, optimizer="adafactor", **opt_over)
    mesh = make_mesh({"fsdp": 1}, devices=jax.devices()[:1])
    jstep = jax_trainer.make_lm_train_step(jmodel, tx, mesh)
    state = {"params": params, "opt_state": tx.init(params)}
    model = port_llama.Llama(pcfg)
    model.load_state_dict(params_from_jax(params, pcfg))
    opt = trainer.make_optimizer(model, LR, optimizer="adafactor", **opt_over)
    return jstep, state, mesh, model, opt


def _factored_state(opt_state):
    """optax's FactoredState inside a (possibly chained) adafactor state."""
    import jax
    from optax._src.factorized import FactoredState

    is_fs = lambda x: isinstance(x, FactoredState)  # noqa: E731
    (fs,) = [x for x in jax.tree.leaves(opt_state, is_leaf=is_fs) if is_fs(x)]
    return fs


def _by_path(tree) -> dict:
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in flat}


def _port_state(opt_state) -> dict:
    """optax's adafactor state as the port's ``state_dict()``."""
    fs = _factored_state(opt_state)
    stats: dict = {}
    for key in ("v_row", "v_col", "v"):
        for path, a in _by_path(getattr(fs, key)).items():
            t = torch.from_numpy(np.asarray(a, np.float32))
            stats.setdefault(path, {})[key] = t.to(torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32)
    return {"count": int(fs.count), "adafactor": stats}


def _run_both(param_dtype, opt_over, n_steps=3, teacher=False):
    """Per step: both losses, the port's state dict and JAX's through
    params_from_jax; JAX's initial params likewise; both optimizers at the
    end. With ``teacher``, each port step starts from JAX's parameters and
    optimizer state before that step."""
    import jax

    jstep, state, mesh, model, opt = _setup(param_dtype, opt_over)
    step = trainer.make_lm_train_step(model, opt)
    out = [(None, None, None, params_from_jax(state["params"], model.cfg))]
    for i in range(n_steps):
        toks = llama_train.synthetic_bigram_batch(B, S, 256, i)
        if teacher:
            model.load_state_dict(out[-1][3])
            opt.load_state_dict(_port_state(jax.device_get(state["opt_state"])))
        with mesh:
            state, jloss = jstep(state, toks)
        ploss = step(torch.from_numpy(toks).long())
        jsd = params_from_jax(jax.device_get(state["params"]), model.cfg)
        port = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out.append((float(jloss), float(ploss), port, jsd))
    return out[1:], out[0][3], opt, jax.device_get(state["opt_state"])


CASES = [
    (dtype, sched, clip)
    for dtype in ("float32", "bfloat16")
    for sched in ("constant", "cosine")
    for clip in (None, 1.0)
]


@pytest.mark.parametrize(
    "param_dtype,schedule,grad_clip", CASES,
    ids=[f"{d}-{s}-clip{c}" for d, s, c in CASES],
)
def test_three_adafactor_steps_match_optax(param_dtype, schedule, grad_clip):
    opt_over = dict(schedule=schedule, grad_clip=grad_clip)
    if schedule == "cosine":
        opt_over.update(warmup_steps=1, decay_steps=4)
    teacher = param_dtype == "bfloat16"
    steps, before, opt, jopt = _run_both(param_dtype, opt_over, teacher=teacher)
    for i, (jl, pl, port, jsd) in enumerate(steps):
        np.testing.assert_allclose(pl, jl, rtol=1e-4, err_msg=f"loss, step {i}")
        assert port.keys() == jsd.keys()
        for name, p in port.items():
            a, b = p.float().numpy(), jsd[name].float().numpy()
            if not teacher:
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f"{name}, step {i}")
            elif p.dtype == torch.float32:  # a norm scale of the bf16 model
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=f"{name}, step {i}")
            else:
                z = before[name].float().numpy()
                if np.any(b != z):
                    err = np.linalg.norm(a - b) / np.linalg.norm(b - z)
                    assert err <= 0.10, (name, i, err)
                assert (a != b).mean() <= 0.08, (name, i, (a != b).mean())
        before = jsd
    # The parameters moved: the comparison is not of an unchanged init.
    first = steps[0][2]
    assert any(not torch.equal(steps[-1][2][k], first[k]) for k in first)
    if param_dtype == "float32":
        fs = _factored_state(jopt)
        mine = opt.state_dict()
        assert mine["count"] == int(fs.count) == 3
        for key in ("v_row", "v_col", "v"):
            for path, want in _by_path(getattr(fs, key)).items():
                got = mine["adafactor"][path][key].numpy()
                np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-30, err_msg=f"{path}/{key}")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_state_shapes_follow_optax_leaves(param_dtype):
    """Each JAX leaf's statistics have optax's shapes and dtype (the
    parameter's: bf16 statistics for bf16 parameters): q/k/v factored over
    M (v_row ``[L, heads, D]``) and D (v_col ``[L, M, heads]``), the stacked
    norms and the final norm unfactored. The state is far smaller than
    AdamW's two moments."""
    import jax

    jstep, state, mesh, model, opt = _setup(param_dtype, {})
    fs = _factored_state(state["opt_state"])
    mine = opt.state_dict()["adafactor"]
    for key in ("v_row", "v_col", "v"):
        want = _by_path(getattr(fs, key))
        assert sorted(want) == sorted(mine), key
        for path, w in want.items():
            assert tuple(mine[path][key].shape) == w.shape, (path, key)
            assert str(mine[path][key].dtype).split(".")[-1] == str(w.dtype), (path, key)
    L, M, H, K, D = 2, WIDE["d_model"], WIDE["n_heads"], WIDE["n_kv_heads"], WIDE["head_dim"]
    assert H * D != M  # the heads axis, not a square leaf, decides the shapes below
    q = mine["layers/attn/q_proj/kernel"]
    assert tuple(q["v_row"].shape) == (L, H, D) and tuple(q["v_col"].shape) == (L, M, H)
    assert tuple(mine["layers/attn/k_proj/kernel"]["v_row"].shape) == (L, K, D)
    assert tuple(mine["layers/attn_norm/scale"]["v"].shape) == (L, M)
    assert tuple(mine["final_norm/scale"]["v"].shape) == (M,)
    n_params = sum(p.numel() for p in model.parameters())
    assert opt.state_nbytes() < 0.2 * 2 * 4 * n_params
    del jax


def test_factoring_and_block_rms_follow_the_jax_leaves(monkeypatch):
    """The control for the tolerances above: an adafactor that takes each
    port tensor (one a layer, ``[out, in]``) as its own leaf — its own
    factored axes and its own block RMS — misses optax's first update by far
    more than the stated atol, where the JAX-leaf mapping meets it. Layer 1
    of every stacked leaf starts at twice layer 0's scale, so a layer's RMS
    is not its leaf's; and q/k/v's JAX leaves ``[L, M, heads, D]`` keep
    statistics a head, which the port's ``[heads·D, M]`` tensors would not."""
    import jax

    def one_step(per_tensor: bool):
        jstep, state, mesh, model, opt = _setup("float32", {}, layer1_scale=2.0)
        toks = llama_train.synthetic_bigram_batch(B, S, 256, 0)
        with mesh:
            state, _ = jstep(state, toks)
        jsd = params_from_jax(jax.device_get(state["params"]), model.cfg)
        if per_tensor:
            leaves = [
                convert.JaxLeaf(name, tuple(p.shape), (name,), "same", False)
                for name, p in model.named_parameters()
            ]
            monkeypatch.setattr(convert, "jax_leaves", lambda cfg: leaves)
            opt = trainer.make_optimizer(model, LR, optimizer="adafactor")
        trainer.make_lm_train_step(model, opt)(torch.from_numpy(toks).long())
        return {n: (p - jsd[n]).abs().max().item() for n, p in model.state_dict().items()}

    right, wrong = one_step(False), one_step(True)
    assert max(right.values()) <= 1e-6
    for i in range(2):
        for mod in ("attn.q_proj", "attn.k_proj", "attn.v_proj", "attn.o_proj",
                    "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj", "attn_norm", "mlp_norm"):
            name = f"layers.{i}.{mod}.weight"
            assert wrong[name] > 100 * 1e-6, (name, wrong[name])


def test_adafactor_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, monkeypatch):
    """Stopped by ``max_steps`` at a checkpoint and resumed (parameters,
    statistics and count restored): the second life's losses and the final
    checkpoint equal an uninterrupted run's bit for bit."""
    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager

    kw = dict(
        config="tiny", batch_size=4, seq_len=32, warmup=1, steps=5, lr=1e-2,
        optimizer="adafactor", lr_schedule="cosine", lr_warmup_steps=1, lr_decay_steps=6,
        grad_clip=1.0, checkpoint_every=3, device="cpu", log=lambda m: None,
    )
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", str(tmp_path / "whole"))
    whole = llama_train.run(max_steps=6, **kw)
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", str(tmp_path / "split"))
    first = llama_train.run(max_steps=3, **kw)
    second = llama_train.run(max_steps=6, **kw)
    assert (whole["end_step"], first["end_step"], second["end_step"]) == (6, 3, 6)
    assert first["losses"] == whole["losses"][:3] and second["losses"] == whole["losses"][3:]
    assert whole["optimizer"] == "adafactor" and whole["optimizer_state_bytes"] > 0
    like = {"params": {}, "opt_state": {}}
    sa = CheckpointManager(tmp_path / "whole", create=False).restore(like)
    sb = CheckpointManager(tmp_path / "split", create=False).restore(like)
    for name, t in sa["params"].items():
        assert torch.equal(sb["params"][name], t), name
    assert sa["opt_state"]["count"] == sb["opt_state"]["count"] == 6
    for path, st in sa["opt_state"]["adafactor"].items():
        for key, t in st.items():
            assert torch.equal(sb["opt_state"]["adafactor"][path][key], t), (path, key)


def test_adafactor_needs_the_model():
    model = port_llama.Llama(port_llama.llama_tiny())
    with pytest.raises(TypeError, match="needs the model"):
        trainer.make_optimizer(model.parameters(), LR, optimizer="adafactor")
    with pytest.raises(ValueError, match="not in"):
        trainer.make_optimizer(model, LR, optimizer="sgd")
