"""Small CNN for digit classification — the port of
``pytorch_operator_tpu/models/mnist.py``.

images ``[B, H, W, 1]`` (NHWC, as the JAX module takes them) → f32 logits
``[B, num_classes]``: conv32 → ReLU → conv64 → ReLU → 2×2 max-pool →
dense128 → ReLU → dense10. What the port keeps of flax's arithmetic:

- Compute in ``dtype`` (``mnist_train`` uses bf16) over f32 parameters: the
  input and each conv's and the first dense's weights cast to ``dtype``
  at each use; the last dense runs in f32 on the ``dtype`` activations,
  promoted.
- SAME for a 3×3 stride-1 conv is a pad of 1 on every side.
- The flatten is in (h, w, c) order, as flax flattens NHWC: the convs run
  NCHW here, so the pooled map is permuted to NHWC before the flatten, and
  ``Dense_0``'s input rows follow the JAX kernel's.

Parameter names follow the flax tree (``Conv_0``, ``Conv_1``, ``Dense_0``,
``Dense_1``); ``models/convert.mnist_params_from_jax`` maps a JAX tree onto
them. The seeded init draws flax's defaults in distribution (LeCun normal,
truncated at two standard deviations, zero biases).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F


class DigitCNN(nn.Module):
    """conv32-conv64-pool-dense128-dense10, NHWC 8×8 digits in, f32 logits
    out (the flax module infers ``Dense_0``'s width from its input; the
    digits give 4·4·64 = 1,024)."""

    def __init__(self, num_classes: int = 10, dtype: Any = torch.float32, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(1, 32, 3, padding=1)
        self.Conv_1 = nn.Conv2d(32, 64, 3, padding=1)
        self.Dense_0 = nn.Linear(4 * 4 * 64, 128)
        self.Dense_1 = nn.Linear(128, num_classes)
        self.init_weights(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DigitCNN":
        """flax's default initializers in distribution: LeCun normal
        (variance 1/fan_in, truncated at ±2σ and rescaled as flax's
        ``variance_scaling`` does) for every kernel, zero biases."""
        for m in (self.Conv_0, self.Conv_1, self.Dense_0, self.Dense_1):
            std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            m.weight.copy_(w)
            m.bias.zero_()
        return self

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.relu(F.conv2d(x, self.Conv_0.weight.to(dt), self.Conv_0.bias.to(dt), padding=1))
        x = F.relu(F.conv2d(x, self.Conv_1.weight.to(dt), self.Conv_1.bias.to(dt), padding=1))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c), flax's order
        x = F.relu(F.linear(x, self.Dense_0.weight.to(dt), self.Dense_0.bias.to(dt)))
        return F.linear(x.float(), self.Dense_1.weight, self.Dense_1.bias)
