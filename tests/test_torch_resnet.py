"""The port's ResNet (pytorch_operator_tpu_torch/models/resnet.py) against the
JAX package's, on the CPU.

- Logits, loss, every gradient and the batch-norm running buffers of one
  training forward, from the same JAX weights carried across
  (``convert.resnet_params_from_jax``), at ``stage_sizes [1, 1]``,
  ``num_filters 8``, 32 px: both block types, the plain and space-to-depth
  stems, f32 and bf16 compute, ``bn_f32_stats=False``.
- Three SGD-nesterov steps of ``resnet_bench.make_train_step`` against the
  JAX bench's own step (``_train_step_fn``, optax's ``sgd(nesterov=True)``):
  the losses, the parameters and the running buffers.
- The converter at ResNet-50 width (every leaf, every shape, 25,557,032
  parameters and 53,120 statistics); the space-to-depth stem against the
  plain stem on the same weights; the init's moments at ResNet-50 width;
  ``channels_last`` activations.
- Two planted faults read above the limits they must break: PyTorch's
  symmetric padding for SAME, and ``nn.BatchNorm2d``'s unbiased running
  variance.

Limits (set from readings on this CPU, about 10x above them): f32 logits
within ``F32_LOGITS_ATOL`` (readings ≤ 1.6e-6), each gradient within
``F32_GRAD_RTOL`` of the JAX one by relative L2 (≤ 2e-5), running buffers
within ``F32_STATS_ATOL`` (≤ 6e-7); bf16 in ``BF16_*`` (readings: logits
≤ 1.8e-2, gradients ≤ 5.3e-2, buffers ≤ 8.9e-3), where the two frameworks
round at different points of the same bf16 program.
"""

import functools

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from pytorch_operator_tpu.models import resnet as jax_resnet
from pytorch_operator_tpu.workloads import resnet_bench as jax_bench
from pytorch_operator_tpu_torch.models import resnet as port_resnet
from pytorch_operator_tpu_torch.models.convert import resnet_params_from_jax
from pytorch_operator_tpu_torch.workloads import resnet_bench as port_bench

B, HW, CLASSES = 4, 32, 10
TINY = dict(stage_sizes=[1, 1], num_classes=CLASSES, num_filters=8)
BLOCKS = {"bottleneck": (jax_resnet.BottleneckBlock, port_resnet.BottleneckBlock),
          "basic": (jax_resnet.BasicBlock, port_resnet.BasicBlock)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

F32_LOGITS_ATOL = 2e-5
F32_GRAD_RTOL = 2e-4
F32_STATS_ATOL = 5e-6
BF16_LOGITS_ATOL = 0.05
BF16_GRAD_RTOL = 0.2
BF16_STATS_ATOL = 0.03
# bn_f32_stats=False: flax's E[x²] − E[x]² in bf16 cancels, and each
# framework's bf16 backward through it rounds at other points, so no single
# leaf that a batch norm's backward reaches is bounded by the rounding
# (readings: the worst leaf 0.25-0.26, a BN bias among them; following
# flax's bf16 op order in the port moved it to 0.21-0.37). Held instead: the
# median leaf (readings 0.043-0.156) and the head, whose gradient passes
# through no batch norm's backward (readings ≤ 1.4e-2). A backward that
# treats the batch statistics as constants reads a median of 1.2-1.7.
BF16_STATS_GRAD_MEDIAN_RTOL = 0.3
BF16_STATS_HEAD_GRAD_RTOL = 0.05

CASES = {
    "bottleneck_f32": dict(block="bottleneck", dtype="f32"),
    "basic_f32": dict(block="basic", dtype="f32"),
    "bottleneck_s2d_f32": dict(block="bottleneck", dtype="f32", s2d_stem=True),
    "basic_s2d_f32": dict(block="basic", dtype="f32", s2d_stem=True),
    "bottleneck_bf16": dict(block="bottleneck", dtype="bf16"),
    "basic_bf16": dict(block="basic", dtype="bf16"),
    "bottleneck_s2d_bf16": dict(block="bottleneck", dtype="bf16", s2d_stem=True),
    "bottleneck_bn_bf16_stats": dict(block="bottleneck", dtype="bf16", bn_f32_stats=False),
    "basic_bn_bf16_stats": dict(block="basic", dtype="bf16", bn_f32_stats=False),
}


def _images(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, HW, HW, 3)).astype(np.float32), (np.arange(n) % CLASSES)


def _models(block="bottleneck", dtype="f32", **kw):
    jb, pb = BLOCKS[block]
    jdt, pdt = DTYPES[dtype]
    jm = jax_resnet.ResNet(**TINY, block_cls=jb, dtype=jdt, **kw)
    pm = port_resnet.ResNet(**TINY, block_cls=pb, dtype=pdt, **kw)
    return jm, pm


@functools.lru_cache(maxsize=None)
def _jax_init(block, dtype, s2d_stem, bn_f32_stats):
    """JAX weights with every leaf moved off its init by noise (the zero BN
    scales would otherwise leave each block's last conv untested)."""
    jm, _ = _models(block, dtype, s2d_stem=s2d_stem, bn_f32_stats=bn_f32_stats)
    v = jm.init(jax.random.key(0), jnp.zeros((1, HW, HW, 3)), train=False)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.1 * rng.standard_normal(a.shape).astype(np.float32)).astype(a.dtype),
        jax.device_get(v["params"]),
    )
    return params, jax.device_get(v["batch_stats"])


def _jax_forward(jm, params, stats, x, y):
    def loss_fn(p):
        logits, upd = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                               mutable=["batch_stats"])
        labels = optax.smooth_labels(jax.nn.one_hot(y, CLASSES), 0.1)
        return optax.softmax_cross_entropy(logits, labels).mean(), (logits, upd["batch_stats"])

    (loss, (logits, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return float(loss), np.asarray(logits), jax.device_get(grads), jax.device_get(new_stats)


def _port_forward(pm, x, y):
    logits = pm(torch.from_numpy(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y).long(), label_smoothing=0.1)
    loss.backward()
    return float(loss.detach()), logits.detach().float().numpy()


def _rel(a, b, floor=0.0) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor, 1e-30))


def _case_readings(block, dtype, s2d_stem=False, bn_f32_stats=True):
    jm, pm = _models(block, dtype, s2d_stem=s2d_stem, bn_f32_stats=bn_f32_stats)
    params, stats = _jax_init(block, dtype, s2d_stem, bn_f32_stats)
    pm.load_state_dict(resnet_params_from_jax(params, stats))
    x, y = _images()
    j_loss, j_logits, j_grads, j_stats = _jax_forward(jm, params, stats, x, y)
    p_loss, p_logits = _port_forward(pm, x, y)
    want_g = resnet_params_from_jax(j_grads, {})
    named = dict(pm.named_parameters())
    # A gradient that is ~0 by symmetry is held against a tenth of the mean
    # gradient norm.
    floor = 0.1 * np.mean([np.linalg.norm(g.numpy()) for g in want_g.values()])
    grad_rel = {k: _rel(named[k].grad.float().numpy(), g.numpy(), floor) for k, g in want_g.items()}
    buffers = dict(pm.named_buffers())
    stats_err = max(
        float(np.abs(buffers[k].float().numpy() - v.numpy()).max())
        for k, v in resnet_params_from_jax({}, j_stats).items()
    )
    return dict(loss=abs(p_loss - j_loss), logits=float(np.abs(p_logits - j_logits).max()),
                grad=max(grad_rel.values()), grad_median=float(np.median(list(grad_rel.values()))),
                grad_head=max(v for k, v in grad_rel.items() if k.startswith("Dense_0.")),
                stats=stats_err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_backward_and_stats_match_jax(case):
    kw = CASES[case]
    r = _case_readings(**kw)
    f32 = kw["dtype"] == "f32"
    assert r["logits"] <= (F32_LOGITS_ATOL if f32 else BF16_LOGITS_ATOL), r
    if kw.get("bn_f32_stats", True):
        assert r["grad"] <= (F32_GRAD_RTOL if f32 else BF16_GRAD_RTOL), r
    else:
        assert r["grad_median"] <= BF16_STATS_GRAD_MEDIAN_RTOL, r
        assert r["grad_head"] <= BF16_STATS_HEAD_GRAD_RTOL, r
    assert r["stats"] <= (F32_STATS_ATOL if f32 else BF16_STATS_ATOL), r


def test_planted_symmetric_same_padding_reads_above_the_limit(monkeypatch):
    """``nn.Conv2d(padding=k // 2)``'s (1, 1) in place of XLA's (0, 1) for
    the stride-2 3×3 convs on even inputs."""
    monkeypatch.setattr(port_resnet, "same_pads", lambda size, k, stride: ((k - 1) // 2,) * 2)
    r = _case_readings("bottleneck", "f32")
    assert r["logits"] > 100 * F32_LOGITS_ATOL, r
    r = _case_readings("basic", "bf16")
    assert r["logits"] > BF16_LOGITS_ATOL or r["grad"] > BF16_GRAD_RTOL, r


def test_planted_unbiased_running_variance_reads_above_the_limit(monkeypatch):
    """``nn.BatchNorm2d``'s running update (momentum 0.1 on the unbiased
    variance, the same numbers flax writes as 0.9 / biased otherwise)."""

    def unbiased(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            True, 0.1, port_resnet.BN_EPS)

    monkeypatch.setattr(port_resnet.BatchNorm, "_fused", unbiased)
    r = _case_readings("bottleneck", "f32")
    assert r["logits"] <= F32_LOGITS_ATOL  # the forward is the same
    assert r["stats"] > 100 * F32_STATS_ATOL, r


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
def test_planted_constant_statistics_backward_reads_above_the_bf16_stats_limit(block, monkeypatch):
    """On the bf16-statistics path, a batch-norm backward that drops the
    gradient through the batch mean and variance."""
    normalize = port_resnet.BatchNorm._normalize
    monkeypatch.setattr(port_resnet.BatchNorm, "_normalize",
                        lambda self, x, mean, var: normalize(self, x, mean.detach(), var.detach()))
    r = _case_readings(block, "bf16", bn_f32_stats=False)
    assert r["grad_median"] > BF16_STATS_GRAD_MEDIAN_RTOL, r


@pytest.mark.parametrize("block,dtype", [("bottleneck", "f32"), ("basic", "f32"), ("bottleneck", "bf16")])
def test_three_sgd_nesterov_steps_match_optax(block, dtype):
    """``resnet_bench.make_train_step`` against the JAX bench's step on the
    same batch: each step's loss, then the parameters and running buffers."""
    jm, pm = _models(block, dtype)
    params, stats = _jax_init(block, dtype, False, True)
    pm.load_state_dict(resnet_params_from_jax(params, stats))
    x, y = _images(seed=2)
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    step = jax.jit(jax_bench._train_step_fn(jm, tx))
    opt_state = tx.init(params)
    step_fn, _ = port_bench.make_train_step(pm, lr=0.1, momentum=0.9)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    j_losses, p_losses = [], []
    for _ in range(3):
        params, stats, opt_state, loss = step(params, stats, opt_state, x, y)
        j_losses.append(float(loss))
        p_losses.append(float(step_fn(xt, yt)))
    f32 = dtype == "f32"
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-5 if f32 else 2e-2)
    want = resnet_params_from_jax(jax.device_get(params), jax.device_get(stats))
    got = pm.state_dict()
    floor = 0.1 * np.mean([np.linalg.norm(v.numpy()) for v in want.values()])
    worst = max(_rel(got[k].float().numpy(), v.numpy(), floor) for k, v in want.items())
    assert worst <= (F32_GRAD_RTOL if f32 else BF16_GRAD_RTOL), worst


def test_converter_at_resnet50_width():
    """Every JAX leaf of ResNet-50 lands on a port tensor of its shape (both
    stems): 25,557,032 parameters and 53,120 batch statistics."""
    for s2d in (False, True):
        jm = jax_resnet.ResNet50(s2d_stem=s2d)
        shapes = jax.eval_shape(functools.partial(jm.init, train=False), jax.random.key(0),
                                jnp.zeros((1, 224, 224, 3)))
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        params, stats = zeros["params"], zeros["batch_stats"]
        sd = resnet_params_from_jax(params, stats)
        assert len(sd) == len(jax.tree.leaves(params)) + len(jax.tree.leaves(stats))
        pm = port_resnet.ResNet50(s2d_stem=s2d)
        want = pm.state_dict()
        assert sd.keys() == want.keys()
        assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in want.items()}
        assert sum(p.numel() for p in pm.parameters()) == 25_557_032
        assert sum(b.numel() for b in pm.buffers()) == 53_120
        assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"])) == 25_557_032
        assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["batch_stats"])) == 53_120
    # Kernels change layout: HWIO -> OIHW, Dense [in, out] -> [out, in].
    params["conv_init"]["kernel"] = np.arange(7 * 7 * 3 * 64, dtype=np.float32).reshape(7, 7, 3, 64)
    params["Dense_0"]["kernel"] = np.arange(2048 * 1000, dtype=np.float32).reshape(2048, 1000)
    sd = resnet_params_from_jax(params, stats)
    assert sd["conv_init.weight"][5, 2, 1, 6] == params["conv_init"]["kernel"][1, 6, 2, 5]
    assert sd["Dense_0.weight"][7, 11] == params["Dense_0"]["kernel"][11, 7]


def test_space_to_depth_stem_equals_the_plain_stem():
    """The s2d stem is an exact rewrite: the same weights give the same
    logits (f32: up to summation order) and the same stem gradient."""
    x, y = _images(seed=3)
    plain = port_resnet.ResNet(**TINY, dtype=torch.float32, seed=4)
    s2d = port_resnet.ResNet(**TINY, dtype=torch.float32, s2d_stem=True, seed=4)
    assert s2d.load_state_dict(plain.state_dict()) is not None
    _, a = _port_forward(plain, x, y)
    _, b = _port_forward(s2d, x, y)
    np.testing.assert_allclose(b, a, atol=1e-5)
    np.testing.assert_allclose(s2d.conv_init.weight.grad.numpy(), plain.conv_init.weight.grad.numpy(),
                               rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="even H/W"):
        s2d(torch.zeros(1, 31, 32, 3))


def test_init_moments_at_resnet50_width():
    """Each conv kernel ~ normal(0, sqrt(2 / fan_out)), the head a
    truncated normal of std sqrt(1 / fan_in) within ±2/.8796 of it, the last
    BN of each block at scale 0, every other at 1, biases and means 0,
    variances 1."""
    pm = port_resnet.ResNet50()
    for name, m in pm.named_modules():
        if isinstance(m, (port_resnet.Conv, port_resnet.SpaceToDepthStem)):
            w = m.weight.detach().double()
            cout, _, kh, kw = w.shape
            std = (2.0 / (kh * kw * cout)) ** 0.5
            assert abs(w.std().item() / std - 1) < 0.05, name
            assert abs(w.mean().item()) < 5 * std / w.numel() ** 0.5, name
    w = pm.Dense_0.weight.detach().double()
    std = (1.0 / 2048) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 * std / port_resnet.TRUNC_STD
    assert not pm.Dense_0.bias.any()
    for name in pm.block_names:
        blk = getattr(pm, name)
        assert not blk.BatchNorm_2.weight.any() and bool((blk.BatchNorm_0.weight == 1).all())
    assert bool((pm.bn_init.running_var == 1).all()) and not pm.bn_init.running_mean.any()
    # The same seed, the same weights; another seed, others.
    again = port_resnet.ResNet50()
    assert torch.equal(again.conv_init.weight, pm.conv_init.weight)
    assert not torch.equal(port_resnet.ResNet50(seed=1).conv_init.weight, pm.conv_init.weight)


def test_channels_last_activations():
    """An NHWC batch permuted to NCHW is already channels_last; a
    channels_last model keeps every conv output so and computes the same
    logits."""
    x, y = _images(seed=5)
    pm = port_resnet.ResNet(**TINY, dtype=torch.float32, seed=6)
    want = pm(torch.from_numpy(x)).detach()
    pm.to(memory_format=torch.channels_last)
    assert port_resnet.memory_format(pm) == torch.channels_last
    formats = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: formats.append(o.is_contiguous(memory_format=torch.channels_last)))
        for m in pm.modules() if isinstance(m, port_resnet.Conv)]
    got = pm(torch.from_numpy(x)).detach()
    for h in hooks:
        h.remove()
    assert formats and all(formats)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_eval_mode_uses_running_statistics():
    """``train=False`` normalises with the running buffers, as flax's
    ``use_running_average``; no buffer moves."""
    jm, pm = _models("bottleneck", "f32")
    params, stats = _jax_init("bottleneck", "f32", False, True)
    stats = jax.tree.map(lambda a: a + 0.3, stats)
    pm.load_state_dict(resnet_params_from_jax(params, stats))
    x, _ = _images(seed=7)
    want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x, train=False))
    before = {k: v.clone() for k, v in pm.named_buffers()}
    got = pm(torch.from_numpy(x), train=False).detach().numpy()
    np.testing.assert_allclose(got, want, atol=F32_LOGITS_ATOL)
    assert all(torch.equal(v, before[k]) for k, v in pm.named_buffers())


def test_resnet50_f32_conditioning_at_the_card_check_shape():
    """Why ``chip_smoke.py`` phase 12(a) holds ResNet-50's gradients to a
    wider limit than its logits and buffers: at its shape (full width, f32,
    B2 x 64 px, BN scales drawn around 1) a one-ulp change of the input
    moves the gradients by ~1e-2 on the CPU alone (the last stage's batch
    norms see 8 values a channel), the size of the card-vs-CPU reading. The
    card's gap must stay inside the limits that this spread sets."""
    import chip_smoke

    x, y = chip_smoke._image_batch(2, 64)
    ref = chip_smoke._grads_and_buffers(chip_smoke._resnet50_f32(), x, y)
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
    moved = chip_smoke._grads_and_buffers(chip_smoke._resnet50_f32(), x * (1 + 2**-23 * noise), y)
    gap = chip_smoke._gap(moved, ref)
    limits = chip_smoke.IMAGE_CARD_CPU_RTOL
    assert 1e-3 < gap["grad"] < limits["grad"], gap
    assert gap["logits"] < limits["logits"] and gap["buffers"] < limits["buffers"], gap


def test_padded_conv_weight_gradient_is_finite_where_a_tap_sees_only_padding():
    """The bf16 weight gradient of a 3×3, stride-2 SAME conv on a 1×1 input
    (ResNet-18's last stage at 16 px): only the centre tap meets the input,
    so every other tap's gradient is exactly 0. The CPU's conv given
    ``padding`` read unwritten memory for those taps and returned non-finite
    values in some calls on the same inputs (the file bench's ``nan`` losses,
    ROADMAP Queue 3); 200 calls of the port's conv must all be finite and
    exact."""
    gen = torch.Generator().manual_seed(0)
    conv = port_resnet.Conv(256, 512, 3, stride=2)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.05, generator=gen)
    x = torch.randn(8, 256, 1, 1, generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(8, 512, 1, 1, generator=gen).to(torch.bfloat16)
    g = g.contiguous(memory_format=torch.channels_last)
    centre = None
    for _ in range(200):
        conv.weight.grad = None
        conv(x).backward(g)
        gw = conv.weight.grad
        assert torch.isfinite(gw).all()
        off = gw.clone()
        off[:, :, 1, 1] = 0
        assert not off.any()
        if centre is None:
            centre = gw[:, :, 1, 1].clone()
        assert torch.equal(gw[:, :, 1, 1], centre)
