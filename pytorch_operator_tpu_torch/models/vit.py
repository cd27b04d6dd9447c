"""Vision Transformer (ViT) for image classification — the port of
``pytorch_operator_tpu/models/vit.py``.

images ``[B, H, W, 3]`` (NHWC, as the JAX module takes them) → f32 logits
``[B, classes]``: a strided-conv patch embedding, a [CLS] token and learned
position embeddings, ``depth`` pre-norm encoder blocks with bidirectional
attention, a final LayerNorm and a head on token 0. bf16 compute over f32
parameters (``ViTConfig.dtype``/``param_dtype``), as there. What the port
keeps of flax's arithmetic:

- LayerNorm: epsilon 1e-6 (PyTorch's default is 1e-5), statistics and
  normalisation in f32, output cast to ``dtype``.
- GELU is the tanh form (``nn.gelu``'s default ``approximate=True``).
- Dense attention: scores ``q·kᵀ/√hd`` in f32 (the reference's
  ``preferred_element_type``), the softmax in f32, ``p`` cast to ``dtype``
  before ``p·v``. ``attn_impl="flash"`` runs ``ops/flash_attention``
  non-causal: the Hopper kernels on the card (S padded to 64 with the padded
  keys masked through ``kv_len``), their plain versions on the CPU.
- The head and ``cls`` start at zero; every Dense and the patch conv use
  ``xavier_uniform`` with a zero bias; ``pos_embed`` ``normal(0.02)``.
- ``remat``: each block under ``torch.utils.checkpoint`` with
  ``models/common.remat_policy`` (``full`` or ``dots``).

Parameter names follow the flax tree (``patch_embed``, ``cls``,
``pos_embed``, ``layers.<i>.{attn_norm,q_proj,k_proj,v_proj,o_proj,mlp_norm,
up_proj,down_proj}``, ``final_norm``, ``head``); the JAX layers are stacked
by ``nn.scan`` and ``models/convert.vit_params_from_jax`` unstacks them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import remat_policy

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    depth: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attn_impl: str = "dense"  # "dense" | "flash"
    remat: bool = False
    remat_policy: str = "full"

    @property
    def grid(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"image {self.image_size} not divisible by patch {self.patch_size}")
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # + [CLS]


def vit_s16(**over) -> ViTConfig:
    return ViTConfig(**{"d_model": 384, "depth": 12, "n_heads": 6, "d_ff": 1536, **over})


def vit_b16(**over) -> ViTConfig:
    return ViTConfig(**over)


def vit_l16(**over) -> ViTConfig:
    return ViTConfig(**{"d_model": 1024, "depth": 24, "n_heads": 16, "d_ff": 4096, **over})


BY_NAME = {"s16": vit_s16, "b16": vit_b16, "l16": vit_l16}


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype)``: f32 statistics, epsilon 1e-6."""

    def __init__(self, d: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, LN_EPS).to(self.dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype)``: the ``[out, in]`` weight and the bias cast to
    ``dtype`` at each use."""

    def __init__(self, d_in: int, d_out: int, dtype):
        super().__init__(d_in, d_out)
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x, self.weight.to(self.dtype), self.bias.to(self.dtype))


class EncoderBlock(nn.Module):
    """Pre-norm transformer encoder block (bidirectional attention)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.d_model, cfg.dtype
        self.attn_norm = LayerNorm(D, dt)
        self.q_proj, self.k_proj, self.v_proj = (Dense(D, D, dt) for _ in range(3))
        self.o_proj = Dense(D, D, dt)
        self.mlp_norm = LayerNorm(D, dt)
        self.up_proj = Dense(D, cfg.d_ff, dt)
        self.down_proj = Dense(cfg.d_ff, D, dt)

    def forward(self, x):
        cfg = self.cfg
        B, S, D = x.shape
        H = cfg.n_heads
        hd = D // H
        y = self.attn_norm(x)
        q, k, v = (proj(y).view(B, S, H, hd) for proj in (self.q_proj, self.k_proj, self.v_proj))
        if cfg.attn_impl == "flash":
            from ..ops.flash_attention import flash_attention

            out = flash_attention(q, k, v, causal=False)
        else:
            s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(hd)
            p = torch.softmax(s, dim=-1).to(cfg.dtype)
            out = torch.einsum("bhst,bthd->bshd", p, v)
        x = x + self.o_proj(out.reshape(B, S, D))
        y = self.up_proj(self.mlp_norm(x))
        return x + self.down_proj(F.gelu(y, approximate="tanh"))


class ViT(nn.Module):
    """``forward(images [B, H, W, 3]) -> logits [B, num_classes]`` (f32).
    Weights are drawn from ``seed`` on the CPU (:meth:`init_weights`), then
    moved to ``device``."""

    def __init__(self, cfg: ViTConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.attn_impl not in ("dense", "flash"):
            raise ValueError(f"attn_impl={cfg.attn_impl!r} not in ('dense', 'flash')")
        remat_policy(cfg)  # validates the policy name
        self.cfg = cfg
        D, p = cfg.d_model, cfg.patch_size
        self.patch_embed = nn.Conv2d(3, D, p, stride=p)
        self.cls = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, D))
        self.layers = nn.ModuleList(EncoderBlock(cfg) for _ in range(cfg.depth))
        self.final_norm = LayerNorm(D, cfg.dtype)
        self.head = nn.Linear(D, cfg.num_classes)
        self.init_weights(torch.Generator().manual_seed(seed))
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ViT":
        """The JAX module's initializers, in distribution: ``xavier_uniform``
        (over the flattened ``[in, out]`` kernel) and zero biases for the
        patch conv and every encoder Dense, ``normal(0.02)`` for
        ``pos_embed``, zeros for ``cls`` and the head, LayerNorm ones and
        zeros."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)) and m is not self.head:
                fan_in = m.weight[0].numel()
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.cls.zero_()
        self.head.weight.zero_()
        self.head.bias.zero_()
        return self

    def forward(self, x):
        cfg = self.cfg
        dt = cfg.dtype
        B = x.shape[0]
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.conv2d(x, self.patch_embed.weight.to(dt), self.patch_embed.bias.to(dt),
                     stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, grid², D], rows then columns
        x = torch.cat([self.cls.to(dt).expand(B, 1, cfg.d_model), x], dim=1)
        x = x + self.pos_embed.to(dt)
        if cfg.remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import noop_context_fn

            context_fn = remat_policy(cfg) or noop_context_fn
            for block in self.layers:
                x = checkpoint(block, x, use_reentrant=False, context_fn=context_fn)
        else:
            for block in self.layers:
                x = block(x)
        x = self.final_norm(x)[:, 0]  # [CLS]
        return F.linear(x.float(), self.head.weight, self.head.bias)
