"""The port's ViT (pytorch_operator_tpu_torch/models/vit.py) against the JAX
package's, on the CPU, at the JAX tests' tiny config (16 px, patch 4, d 32,
depth 2, 2 heads, d_ff 64): the same JAX weights carried across
(``convert.vit_params_from_jax``, the ``nn.scan`` layers unstacked).

- Logits, loss and every gradient, dense and ``attn_impl="flash"`` (the
  JAX kernel in Pallas interpret mode, the port's plain version), f32 and
  bf16.
- Flash against dense on the same weights; remat ``full`` and ``dots``
  against no remat (the JAX tests' cases).
- The converter at ViT-B/16 width (every leaf and shape).
- ``vit_bench``'s step: three AdamW steps against ``optax.adamw`` (weight
  decay 0.05) through the JAX bench's own step function.
- A planted fault, PyTorch's LayerNorm epsilon (1e-5 in place of flax's
  1e-6), reads above the f32 limit.

Limits (about 10x above the readings on this CPU): f32 logits within
``F32_LOGITS_ATOL`` (readings ≤ 4.2e-7), each gradient within
``F32_GRAD_RTOL`` by relative L2 against a floor of a tenth of the mean
gradient norm (≤ 1.35e-6; the k-projection bias's gradient is zero by the
softmax's shift invariance, so only noise is left of it); bf16 in
``BF16_*`` (logits ≤ 1.04e-2, gradients ≤ 3.6e-2). The epsilon fault reads
9.5e-4 on the logits.
"""

import functools

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import flax.linen as nn
import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from pytorch_operator_tpu.models import vit as jax_vit
from pytorch_operator_tpu.workloads import vit_bench as jax_bench
from pytorch_operator_tpu_torch.models import vit as port_vit
from pytorch_operator_tpu_torch.models.convert import vit_params_from_jax
from pytorch_operator_tpu_torch.workloads import vit_bench as port_bench

TINY = dict(image_size=16, patch_size=4, num_classes=10, d_model=32, depth=2, n_heads=2, d_ff=64)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_LOGITS_ATOL = 5e-6
F32_GRAD_RTOL = 2e-5
BF16_LOGITS_ATOL = 0.05
BF16_GRAD_RTOL = 0.1


def _cfgs(dtype="f32", **over):
    jdt, pdt = DTYPES[dtype]
    return (jax_vit.ViTConfig(**{**TINY, "dtype": jdt, **over}),
            port_vit.ViTConfig(**{**TINY, "dtype": pdt, **over}))


def _images(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 16, 16, 3)).astype(np.float32), np.arange(n) % 10


@functools.lru_cache(maxsize=None)
def _jax_params(depth=2):
    """JAX init (key 0) with every leaf moved off it by noise: the zero head
    would otherwise give zero logits and no gradient below it."""
    jcfg, _ = _cfgs(depth=depth)
    params = nn.meta.unbox(jax_vit.ViT(jcfg).init(jax.random.key(0), _images()[0][:1])["params"])
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(params),
    )


def _loss_jax(model, params, x, y):
    logits = model.apply({"params": params}, x)
    labels = optax.smooth_labels(jax.nn.one_hot(y, 10), 0.1)
    return optax.softmax_cross_entropy(logits, labels).mean(), logits


def _port(pcfg, params):
    pm = port_vit.ViT(pcfg)
    pm.load_state_dict(vit_params_from_jax(params))
    return pm


def _port_loss(pm, x, y):
    logits = pm(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y).long(), label_smoothing=0.1)
    loss.backward()
    return float(loss.detach()), logits.detach().numpy()


def _grad_gap(pm, jax_grads) -> float:
    want = vit_params_from_jax(jax_grads)
    named = dict(pm.named_parameters())
    floor = 0.1 * np.mean([np.linalg.norm(g.numpy()) for g in want.values()])
    return max(
        np.linalg.norm(named[k].grad.float().numpy() - g.numpy()) / max(np.linalg.norm(g.numpy()), floor)
        for k, g in want.items()
    )


def _readings(attn_impl, dtype):
    jcfg, pcfg = _cfgs(dtype, attn_impl=attn_impl)
    params = _jax_params()
    x, y = _images()
    (j_loss, j_logits), grads = jax.value_and_grad(
        functools.partial(_loss_jax, jax_vit.ViT(jcfg)), has_aux=True)(params, x, y)
    pm = _port(pcfg, params)
    p_loss, p_logits = _port_loss(pm, x, y)
    return dict(loss=abs(p_loss - float(j_loss)),
                logits=float(np.abs(p_logits - np.asarray(j_logits)).max()),
                grad=_grad_gap(pm, jax.device_get(grads)))


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_logits_and_gradients_match_jax(attn_impl, dtype):
    r = _readings(attn_impl, dtype)
    f32 = dtype == "f32"
    assert r["logits"] <= (F32_LOGITS_ATOL if f32 else BF16_LOGITS_ATOL), r
    assert r["grad"] <= (F32_GRAD_RTOL if f32 else BF16_GRAD_RTOL), r


def test_forward_shape_and_finite():
    _, pcfg = _cfgs()
    logits = port_vit.ViT(pcfg)(torch.from_numpy(_images()[0]))
    assert logits.shape == (3, 10) and bool(torch.isfinite(logits).all())
    assert not logits.any()  # the head starts at zero


def test_flash_attention_matches_dense():
    """attn_impl='flash' (the plain version on the CPU) against dense on the
    same weights, at the JAX test's tolerance."""
    params = _jax_params()
    x, _ = _images(seed=1, n=2)
    yd = _port(_cfgs()[1], params)(torch.from_numpy(x)).detach().numpy()
    yf = _port(_cfgs(attn_impl="flash")[1], params)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(yd, yf, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_same_numerics(policy):
    """remat under either policy: the loss and every gradient of no remat
    (the JAX test's rtol 1e-5 / 1e-4, atol 1e-6)."""
    params = _jax_params(depth=6)
    x = np.random.default_rng(0).random((16, 16, 16, 3), np.float32)
    y = np.arange(16) % 10
    out = {}
    for remat in (False, True):
        pm = _port(_cfgs(depth=6, remat=remat, remat_policy=policy)[1], params)
        loss, _ = _port_loss(pm, x, y)
        out[remat] = (loss, {k: p.grad.clone() for k, p in pm.named_parameters()})
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-5)
    for k, g in out[False][1].items():
        np.testing.assert_allclose(out[True][1][k].numpy(), g.numpy(), rtol=1e-4, atol=1e-6)


def test_converter_at_vit_b16_width():
    """Every JAX leaf of ViT-B/16 (224 px, 1000 classes) lands on a port
    tensor of its shape; the parameter counts agree."""
    jm = jax_vit.ViT(jax_vit.vit_b16())
    shapes = nn.meta.unbox(jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 224, 224, 3)))["params"])
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = vit_params_from_jax(zeros)
    pm = port_vit.ViT(port_vit.vit_b16())
    want = pm.state_dict()
    assert sd.keys() == want.keys()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in want.items()}
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in pm.parameters()) == n
    assert round(n / 1e6, 1) == 86.6
    # The DenseGeneral layouts: q [D, H, hd] -> [H·hd, D]; o [H, hd, D] -> [D, H·hd].
    zeros["layers"]["q_proj"]["kernel"] = np.arange(12 * 768 * 768, dtype=np.float32).reshape(12, 768, 12, 64)
    zeros["layers"]["o_proj"]["kernel"] = np.arange(12 * 768 * 768, dtype=np.float32).reshape(12, 12, 64, 768)
    sd = vit_params_from_jax(zeros)
    assert sd["layers.3.q_proj.weight"][2 * 64 + 5, 7] == zeros["layers"]["q_proj"]["kernel"][3, 7, 2, 5]
    assert sd["layers.3.o_proj.weight"][7, 2 * 64 + 5] == zeros["layers"]["o_proj"]["kernel"][3, 2, 5, 7]


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_three_adamw_steps_match_optax(attn_impl):
    """``vit_bench.make_train_step`` against the JAX bench's step (optax's
    ``adamw(1e-3, weight_decay=0.05)``), f32: each loss, then every
    parameter."""
    jcfg, pcfg = _cfgs(attn_impl=attn_impl)
    jm = jax_vit.ViT(jcfg)
    params = _jax_params()
    pm = _port(pcfg, params)
    tx = optax.adamw(1e-3, weight_decay=0.05)
    step = jax.jit(jax_bench._step_fn(jm, tx))
    opt_state = tx.init(params)
    port_step, _ = port_bench.make_train_step(pm, lr=1e-3)
    x, y = _images(seed=2, n=4)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, x, y)
        assert float(port_step(xt, yt)) == pytest.approx(float(loss), rel=1e-5)
    want = vit_params_from_jax(jax.device_get(params))
    for k, v in pm.state_dict().items():
        # Adam's normalisation turns a gradient's rounding noise into a step
        # of up to lr where the gradient itself is tiny: every parameter is
        # held within 1% of a step, and the k-projection bias, whose gradient
        # is zero but for that noise, within three steps.
        atol = 3e-3 if k.endswith("k_proj.bias") else 1e-5
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=atol, err_msg=k)


def test_planted_layernorm_epsilon_reads_above_the_limit(monkeypatch):
    monkeypatch.setattr(port_vit, "LN_EPS", 1e-5)
    r = _readings("dense", "f32")
    assert r["logits"] > 10 * F32_LOGITS_ATOL or r["grad"] > 10 * F32_GRAD_RTOL, r
