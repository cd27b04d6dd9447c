"""ResNet v1.5 for image classification — the port of
``pytorch_operator_tpu/models/resnet.py``.

Same API as the JAX module: NHWC images in, ``[B, classes]`` f32 logits out;
``dtype`` (bf16 by default) for the convs and activations over f32 master
weights; ``bn_f32_stats``; ``s2d_stem``; depths 18–152 (:data:`BY_DEPTH`);
the flax module and parameter names (``conv_init``, ``bn_init``,
``BottleneckBlock_<i>.Conv_0``, ``...BatchNorm_2``, ``conv_proj``,
``norm_proj``, ``Dense_0``), so a JAX tree maps onto the state dict by name
(``models/convert.resnet_params_from_jax``). Where a PyTorch default
computes something else than the reference, the port does what flax does:

- **SAME padding is XLA's**, low side ``total // 2``: a stride-2 3×3 conv on
  an even input pads (0, 1), not ``padding=1``'s (1, 1) (:func:`same_pads`;
  an asymmetric pad is an ``F.pad`` before the conv).
- **Batch norm** normalises with the batch's mean and *biased* variance in
  f32 and casts to ``dtype``; its running statistics move by
  ``0.9·ra + 0.1·batch`` with the biased variance (``nn.BatchNorm2d`` uses
  the unbiased one). :class:`BatchNorm` runs ``F.batch_norm`` (PyTorch's
  native channels_last kernels on the card) with momentum 1 on scratch
  buffers, un-biases the variance it returns and applies flax's update.
  With ``sync_stats`` (a world of several processes: JAX's batch norm under
  ``jit`` on a dp mesh reduces over the global batch) or
  ``bn_f32_stats=False`` (flax's statistics in bf16), it computes the
  statistics itself: sums all-reduced across the ranks, differentiably,
  then flax's ``E[x²] − E[x]²`` and ``(x − mean)·(rsqrt(var + eps)·scale) +
  bias``. That path serves one process too, but slower: a ResNet-50 B128 ×
  224 px step takes 36.3 ms with ``F.batch_norm`` and 124.8 ms with the
  sums on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase 12(b)).
- The last BN of each block starts with scale 0; convs draw from
  ``variance_scaling(2, fan_out, normal)``, the head from
  ``variance_scaling(1, fan_in, truncated_normal)`` (std / .87962566).
- The head runs in f32 on the f32 cast of the bf16 global mean.

On the card the activations are ``channels_last`` (an NHWC batch permuted to
NCHW already is), so cuDNN runs NHWC kernels without transposes.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
# jax.nn.initializers' truncated_normal stddev correction: the std of a unit
# normal truncated to [-2, 2].
TRUNC_STD = 0.87962566103423978


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` for one spatial dim: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int, pads) -> torch.Tensor:
    """``F.conv2d`` with ``pads = ((top, bottom), (left, right))``.

    On the CPU the pads are always zeros written into the input (``F.pad``):
    the CPU's bf16 weight gradient of a conv given ``padding`` reads memory
    that it never wrote for a tap that sees only padding (a 1×1 input under
    a 3×3 kernel at stride 2 and pad 1, as ResNet-18's last stage meets at
    16 px), and returns non-finite values there in some calls on the same
    inputs (torch 2.13 on the CPU; the card's cuDNN convs take
    ``padding``)."""
    (t, b), (left, r) = pads
    if t == b and left == r and x.device.type != "cpu":
        return F.conv2d(x, w, stride=stride, padding=(t, left))
    return F.conv2d(F.pad(x, (left, r, t, b)), w, stride=stride)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)``: an OIHW f32 weight cast to ``dtype``
    at each use; ``padding`` "SAME" (XLA's) or explicit ``((t, b), (l, r))``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, *, dtype=torch.bfloat16,
                 padding="SAME"):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))

    def forward(self, x):
        k = self.weight.shape[-1]
        pads = self.padding
        if pads == "SAME":
            pads = (same_pads(x.shape[2], k, self.stride), same_pads(x.shape[3], k, self.stride))
        return _conv(x, self.weight.to(self.dtype), self.stride, pads)


class SpaceToDepthStem(nn.Module):
    """The 7×7/stride-2 stem as a 4×4/stride-1 conv on a 2×2 space-to-depth
    transform of the input (exact; see the JAX module): the kernel, kept in
    the canonical ``(F, C, 7, 7)`` shape, is zero-padded to 8×8 at the top
    and left and regrouped ``K4[o, (a, b, c), r, s] = K8[o, c, 2r+a, 2s+b]``;
    the input ``z[n, (a, b, c), p, q] = x[n, c, 2p+a, 2q+b]``; spatial padding
    (2, 1)."""

    def __init__(self, cin: int, features: int, *, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, cin, 7, 7))

    def forward(self, x):
        n, c, h, w = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"space-to-depth stem needs even H/W, got {(h, w)}")
        f = self.weight.shape[0]
        k4 = (
            F.pad(self.weight, (1, 0, 1, 0))
            .reshape(f, c, 4, 2, 4, 2)
            .permute(0, 3, 5, 1, 2, 4)
            .reshape(f, 4 * c, 4, 4)
        )
        z = (
            x.reshape(n, c, h // 2, 2, w // 2, 2)
            .permute(0, 3, 5, 1, 2, 4)
            .reshape(n, 4 * c, h // 2, w // 2)
        )
        if x.is_contiguous(memory_format=torch.channels_last):
            z = z.contiguous(memory_format=torch.channels_last)
        return _conv(z, k4.to(self.dtype), 1, ((2, 1), (2, 1)))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over N, H, W of an
    NCHW batch (see the module docstring). ``f32_stats`` keeps scale, bias
    and the running statistics in f32 and computes the statistics in f32;
    otherwise all of them are in ``param_dtype`` (flax's ``bn_f32_stats=
    False``). ``sync_stats`` reduces the statistics over the world's ranks."""

    def __init__(self, c: int, *, f32_stats: bool = True, param_dtype=torch.float32,
                 zero_scale: bool = False, sync_stats: bool = False):
        super().__init__()
        pdt = torch.float32 if f32_stats else param_dtype
        self.f32_stats, self.sync_stats = f32_stats, sync_stats
        self.weight = nn.Parameter(torch.zeros(c, dtype=pdt) if zero_scale else torch.ones(c, dtype=pdt))
        self.bias = nn.Parameter(torch.zeros(c, dtype=pdt))
        self.register_buffer("running_mean", torch.zeros(c, dtype=pdt))
        self.register_buffer("running_var", torch.ones(c, dtype=pdt))

    def forward(self, x, train: bool = True):
        if not train:
            return self._normalize(x, self.running_mean, self.running_var)
        if self.f32_stats and not self.sync_stats:
            return self._fused(x)
        return self._summed(x)

    def _summed(self, x):
        """The statistics summed here in f32 (all-reduced across the ranks
        with ``sync_stats``), rounded to the statistics' dtype, then flax's
        ``E[x²] − E[x]²`` and :meth:`_normalize`."""
        sdt = torch.float32 if self.f32_stats else self.weight.dtype
        x32 = x.float()
        sums = torch.stack([x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3))])
        count = x.numel() // x.shape[1]
        if self.sync_stats:
            from ..parallel.collectives import axis_size, psum_autograd

            sums = psum_autograd(sums, "dp")
            count *= axis_size("dp")
        mean, mean2 = (sums / count).to(sdt).float()
        var = torch.clamp_min(mean2 - mean * mean, 0.0).to(sdt)
        mean = mean.to(sdt)
        self._update(mean.detach(), var.detach())
        return self._normalize(x, mean, var)

    def _fused(self, x):
        """One ``F.batch_norm``: its momentum-1 running update on scratch
        buffers returns the batch mean and the unbiased variance, which
        becomes the biased one again."""
        c = x.shape[1]
        mean = torch.zeros(c, dtype=torch.float32, device=x.device)
        var = torch.ones(c, dtype=torch.float32, device=x.device)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, BN_EPS)
        n = x.numel() // c
        self._update(mean, var * ((n - 1) / n))
        return y

    @torch.no_grad()
    def _update(self, mean, var):
        dt = self.running_mean.dtype
        self.running_mean.copy_(BN_MOMENTUM * self.running_mean + (1 - BN_MOMENTUM) * mean.to(dt))
        self.running_var.copy_(BN_MOMENTUM * self.running_var + (1 - BN_MOMENTUM) * var.to(dt))

    def _normalize(self, x, mean, var):
        """flax's ``_normalize``: ``(x − mean)·(rsqrt(var + eps)·scale) +
        bias`` in the statistics' dtype, cast to x's."""
        shape = (1, -1, 1, 1)
        mul = (torch.rsqrt(var.float() + BN_EPS).to(var.dtype) * self.weight).float()
        y = (x.float() - mean.float().view(shape)) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3(stride) → 1×1(×4), projection shortcut when the shape
    changes."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, conv, norm):
        super().__init__()
        out = filters * 4
        self.Conv_0, self.BatchNorm_0 = conv(cin, filters, 1), norm(filters)
        self.Conv_1, self.BatchNorm_1 = conv(filters, filters, 3, stride), norm(filters)
        self.Conv_2, self.BatchNorm_2 = conv(filters, out, 1), norm(out, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != out:
            self.conv_proj, self.norm_proj = conv(cin, out, 1, stride), norm(out)

    def forward(self, x, train: bool = True):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x), train)
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3×3 → 3×3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, conv, norm):
        super().__init__()
        self.Conv_0, self.BatchNorm_0 = conv(cin, filters, 3, stride), norm(filters)
        self.Conv_1, self.BatchNorm_1 = conv(filters, filters, 3), norm(filters, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != filters:
            self.conv_proj, self.norm_proj = conv(cin, filters, 1, stride), norm(filters)

    def forward(self, x, train: bool = True):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x), train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """``forward(images [B, H, W, 3], train=True) -> logits [B, classes]``
    (f32). Weights are drawn from ``seed`` on the CPU (the same seed, the same
    weights on any device; :meth:`init_weights`), then moved to ``device``;
    on CUDA the model is ``channels_last``."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        num_classes: int = 1000,
        num_filters: int = 64,
        dtype=torch.bfloat16,
        block_cls=BottleneckBlock,
        bn_f32_stats: bool = True,
        s2d_stem: bool = False,
        sync_stats: bool = False,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        self.dtype = dtype
        conv = partial(Conv, dtype=dtype)
        norm = partial(BatchNorm, f32_stats=bn_f32_stats, param_dtype=dtype, sync_stats=sync_stats)
        if s2d_stem:
            self.conv_init = SpaceToDepthStem(3, num_filters, dtype=dtype)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, dtype=dtype, padding=((3, 3), (3, 3)))
        self.bn_init = norm(num_filters)
        self.block_names = []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block_cls(cin, num_filters * 2**i, stride, conv, norm))
                self.block_names.append(name)
                cin = num_filters * 2**i * block_cls.expansion
        self.Dense_0 = nn.Linear(cin, num_classes)
        self.init_weights(torch.Generator().manual_seed(seed))
        if device is not None:
            self.to(device)
            if torch.device(device).type == "cuda":
                self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """The JAX package's initializers, in distribution: each conv kernel
        ``normal(0, sqrt(2 / fan_out))`` with ``fan_out = k·k·out``; the head
        ``truncated_normal`` on [-2, 2] std of ``sqrt(1 / fan_in) / .87962566``
        and a zero bias (the batch norms keep their constructors' ones and
        zeros)."""
        for m in self.modules():
            if isinstance(m, (Conv, SpaceToDepthStem)):
                cout, _, kh, kw = m.weight.shape
                m.weight.normal_(0.0, (2.0 / (kh * kw * cout)) ** 0.5, generator=generator)
        fan_in = self.Dense_0.in_features
        std = (1.0 / fan_in) ** 0.5 / TRUNC_STD
        nn.init.trunc_normal_(self.Dense_0.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        nn.init.zeros_(self.Dense_0.bias)
        return self

    def forward(self, x, train: bool = True):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC → an NCHW channels_last view
        x = F.relu(self.bn_init(self.conv_init(x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.mean(dim=(2, 3))
        return F.linear(x.float(), self.Dense_0.weight, self.Dense_0.bias)


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])

BY_DEPTH = {18: ResNet18, 34: ResNet34, 50: ResNet50, 101: ResNet101, 152: ResNet152}


def memory_format(model: ResNet) -> Optional[torch.memory_format]:
    """``channels_last`` when every 4-D weight of ``model`` is laid out so,
    ``contiguous_format`` when every one is, else None."""
    ws = [p for p in model.parameters() if p.dim() == 4]
    for fmt in (torch.channels_last, torch.contiguous_format):
        if all(w.is_contiguous(memory_format=fmt) for w in ws):
            return fmt
    return None
