"""Llama-3-family decoder with a KV-cache decode path, in PyTorch.

The counterpart of ``pytorch_operator_tpu/models/llama.py``: RMSNorm with
f32 math, rotate-half rotary embeddings in f32, grouped-query attention
(flash kernel or dense), SwiGLU MLP, an untied LM head computed in f32, and
the serving forward (:func:`decode_forward`) over a flat per-layer cache
(:func:`init_decode_cache`). Module and parameter names follow the JAX
package (``embed``, ``layers.<i>.attn.q_proj``, ``mlp.gate_proj``, ...) so
``convert.params_from_jax`` maps one tree onto the other.

Weights live in PyTorch's ``nn.Linear`` orientation ``[out, in]``. As in
flax (``param_dtype``/``dtype`` on every ``DenseGeneral`` and ``Embed``), the
matmul weights and the embedding table are parameters in ``cfg.param_dtype``
(f32 master weights for training) and are cast to ``cfg.dtype`` at the call,
so their gradients arrive through the cast in the parameter's dtype. Norm
scales stay f32 and the LM head computes in f32. A serving model casts its
matmul weights once at load (:meth:`Llama.cast_matmul_weights_`), after which
the per-call cast is a no-op.

The serving stack's int8 options (``ops/quantize.py``): ``quantize="int8"``
holds each matmul weight, the embedding and the head as an int8 ``weight``
plus an f32 per-row ``scale`` (frozen parameters, so ``state_dict`` and
``load_state_dict(assign=True)`` carry both), dequantized at the use site one
layer at a time to ``bf16(f32(q) * scale)``; ``kv_quantize="int8"`` stores the
cache slabs int8 with per-(token, kv head) f32 scales, written at every cache
write and folded into the scores and probabilities after the dots.

``remat=True`` runs each block under ``torch.utils.checkpoint`` (the JAX
``nn.remat`` of the block): ``remat_policy="full"`` keeps only the block's
input, ``"dots"`` also keeps the outputs of its GEMMs (``models/common.py``).

``n_experts > 0`` replaces each block's MLP with ``moe_mlp``, the top-k
mixture of experts of ``parallel/moe.py`` on this one device (dense or
capacity-factor sparse dispatch); with ``moe_aux_weight > 0`` and
``return_aux=True`` the forward also returns the mean over layers of the
load-balance loss, which each block hands back through its return value (a
rematerialised block runs twice, so no side channel would count once).

``tp=TensorParallel(...)`` (``parallel/sharding.py``) builds the rank's
part of a tensor-parallel model, as JAX's ``shard_map`` and GSPMD give each
device its heads: q/k/v and gate/up hold this rank's heads and ``d_ff``
columns (column-parallel, after ``tp_enter``), o and down the matching
inputs (row-parallel, before ``tp_leave``), the embedding its vocabulary
rows (a masked local lookup, then ``tp_leave``), the head its vocabulary
columns; the norms are whole on every rank. Attention (flash or dense)
runs on the local ``[B, S, H/tp, D]`` and ``[B, S, KH/tp, D]``. Such a
model returns hidden states only: its loss is the vocab-parallel one
(``ops/chunked_xent.vocab_parallel_xent``). Decoding refuses it (JAX's
generate and serve take no mesh).

Not in this port yet (raises ``NotImplementedError`` from the config): ring
and ulysses sequence parallelism. Expert parallelism and pipeline
parallelism have no config field; the port has no ep or pp forward. They
are ROADMAP.md items 3c-2 and 3c-3.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ..ops.flash_attention import flash_attention
from ..ops.quantize import dequantize, quantize, scale_name
from ..parallel.moe import load_balance_loss, moe_mlp_reference, moe_mlp_sparse
from ..parallel.sharding import TensorParallel, check_tp_divides, tp_dim
from .common import remat_policy


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 14_336
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    remat_policy: str = "full"
    # "dense" (materialized S x S scores) or "flash" (ops/flash_attention.py:
    # the CUDA kernel on the card, its plain version on the CPU).
    attn_impl: str = "dense"
    xent_impl: str = "dense"
    n_experts: int = 0
    moe_top_k: int = 2
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.0
    # decode=True: attention reads and writes a KV cache passed by the
    # caller (init_decode_cache), of static length max_decode_len.
    decode: bool = False
    max_decode_len: int = 2048
    kv_quantize: Optional[str] = None
    # Cache writes: False = every row at the offsets of row 0 (the
    # single-stream generate loop); True = each row at its own offset (a
    # continuous-batching engine's mixed-depth batch).
    decode_per_row: bool = False
    # Multi-token decode inputs: "self" = the whole prompt of a fresh cache
    # (causal self-attention over the incoming tokens, flash when
    # configured); "cache" = a chunk at positions [start, start+S) attending
    # against the full cache under the position mask.
    prefill_mode: str = "self"
    quantize: Optional[str] = None

    def __post_init__(self):
        if self.quantize not in (None, "int8"):
            raise ValueError(f"quantize={self.quantize!r} not in (None, 'int8')")
        if self.kv_quantize not in (None, "int8"):
            raise ValueError(
                f"kv_quantize={self.kv_quantize!r} not in (None, 'int8')"
            )
        if self.prefill_mode not in ("self", "cache"):
            raise ValueError(
                f"prefill_mode={self.prefill_mode!r} not in ('self', 'cache')"
            )
        if (self.decode_per_row or self.prefill_mode != "self") and not self.decode:
            raise ValueError(
                "decode_per_row / prefill_mode='cache' require decode=True"
            )
        if self.decode and self.attn_impl in ("ring", "ulysses"):
            raise ValueError(
                f"attn_impl={self.attn_impl!r} is not supported with "
                "decode=True (prefill uses flash/dense self-attention)"
            )
        if self.attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r} is not ported yet "
                "(ROADMAP.md item 3c-2: sequence and expert parallelism)"
            )
        if self.n_experts > 0:
            if self.moe_dispatch not in ("dense", "sparse"):
                raise ValueError(
                    f"moe_dispatch={self.moe_dispatch!r} not in ('dense', 'sparse')"
                )
            if self.moe_dispatch == "sparse" and not self.moe_aux_weight:
                # Capacity-factor dispatch drops over-capacity tokens, so a
                # router that collapses without the load-balance loss also
                # drops most of the batch.
                import warnings

                warnings.warn(
                    "moe_dispatch='sparse' with moe_aux_weight=0: without the "
                    "load-balance loss the router can collapse onto a few "
                    "experts and capacity-factor dispatch then drops most "
                    "tokens. Set moe_aux_weight~1e-2.",
                    stacklevel=2,
                )
        if self.attn_impl not in ("dense", "flash"):
            raise ValueError(f"attn_impl={self.attn_impl!r} not in ('dense', 'flash')")
        if self.remat:
            remat_policy(self)  # an unknown policy raises here, as in JAX
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads={self.n_heads} not a multiple of n_kv_heads={self.n_kv_heads}"
            )

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def llama3_8b(**over) -> LlamaConfig:
    """The Llama-3-8B shape, with the flash kernel and chunked loss defaults."""
    return LlamaConfig(**{"attn_impl": "flash", "xent_impl": "chunked", **over})


def llama_0_3b(**over) -> LlamaConfig:
    """~0.32B-parameter Llama shape (same defaults as :func:`llama3_8b`)."""
    return llama3_8b(
        **{
            "vocab_size": 32000,
            "d_model": 1024,
            "n_layers": 16,
            "n_heads": 8,
            "n_kv_heads": 4,
            "head_dim": 128,
            "d_ff": 4096,
            **over,
        }
    )


def llama_1b(**over) -> LlamaConfig:
    """~1.14B-parameter Llama shape."""
    return llama3_8b(
        **{
            "vocab_size": 32000,
            "d_model": 2048,
            "n_layers": 16,
            "n_heads": 16,
            "n_kv_heads": 8,
            "head_dim": 128,
            "d_ff": 8192,
            **over,
        }
    )


def llama_tiny(**over) -> LlamaConfig:
    """Scaled-down config for tests: same architecture, tiny dims, f32."""
    base = dict(
        vocab_size=256,
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        dtype=torch.float32,
    )
    base.update(over)
    return LlamaConfig(**base)


# --config name -> preset (the JAX package's workloads/llama_train.CONFIGS)
CONFIGS = {
    "8b": "llama3_8b",
    "1b": "llama_1b",
    "0.3b": "llama_0_3b",
    "tiny": "llama_tiny",
}


def _hold_int8(module: nn.Module) -> None:
    """Hold ``module.weight`` ``[out, in]`` as int8 ``q`` plus an f32 per-row
    ``scale`` ``[out, 1]`` (``ops/quantize.py``'s rule), both frozen
    parameters."""
    shape, dev = module.weight.shape, module.weight.device
    module.weight = nn.Parameter(torch.zeros(shape, dtype=torch.int8, device=dev), requires_grad=False)
    module.scale = nn.Parameter(torch.ones((shape[0], 1), device=dev), requires_grad=False)


class _Linear(nn.Linear):
    """A bias-free ``nn.Linear`` whose weight is a ``cfg.param_dtype``
    parameter and whose product runs in ``cfg.dtype`` (flax
    ``DenseGeneral(dtype=..., param_dtype=...)``): input and weight are cast
    at the call. Under ``cfg.quantize`` the weight is int8 with a per-row
    scale, dequantized at the call (the reference's per-layer
    ``dequantize_tree`` to f32, then the dense layer's cast)."""

    def __init__(self, n_in: int, n_out: int, cfg: LlamaConfig, device):
        super().__init__(n_in, n_out, bias=False, device=device, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype
        self.quantized = bool(cfg.quantize)
        if self.quantized:
            _hold_int8(self)

    def forward(self, x):
        if self.quantized:
            w = dequantize(self.weight, self.scale, self.compute_dtype)
        else:
            w = self.weight.to(self.compute_dtype)
        return F.linear(x.to(self.compute_dtype), w)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention. x: [B,S,H,D], positions: [B,S]."""
    half = x.shape[-1] // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    angles = positions[..., None].float() * freqs  # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _local(n: int, tp: Optional[TensorParallel], what: str) -> int:
    """This rank's share of ``n`` under ``tp`` (``n`` itself without)."""
    return n if tp is None else tp.block(n, what)[1]


class Attention(nn.Module):
    """Grouped-query attention with RoPE; self-attention (flash or dense) or,
    with ``cfg.decode``, KV-cache attention. Under ``tp`` it holds and
    attends this rank's heads (``n_heads/tp`` and ``n_kv_heads/tp``)."""

    def __init__(self, cfg: LlamaConfig, device=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        H, K, D = _local(cfg.n_heads, tp, "n_heads"), _local(cfg.n_kv_heads, tp, "n_kv_heads"), cfg.head_dim
        self.n_heads, self.n_kv_heads = H, K
        self.q_proj = _Linear(cfg.d_model, H * D, cfg, device)
        self.k_proj = _Linear(cfg.d_model, K * D, cfg, device)
        self.v_proj = _Linear(cfg.d_model, K * D, cfg, device)
        self.o_proj = _Linear(H * D, cfg.d_model, cfg, device)

    def forward(self, x, positions, cache: Optional[Dict[str, torch.Tensor]] = None):
        cfg = self.cfg
        B, S, _ = x.shape
        H, K, D = self.n_heads, self.n_kv_heads, cfg.head_dim
        if self.tp is not None:
            x = self.tp.enter(x)
        q = apply_rope(self.q_proj(x).view(B, S, H, D), positions, cfg.rope_theta)
        k = apply_rope(self.k_proj(x).view(B, S, K, D), positions, cfg.rope_theta)
        v = self.v_proj(x).view(B, S, K, D)
        if cfg.decode:
            if cache is None:
                raise ValueError("decode=True needs the layer's cache (init_decode_cache)")
            out = self._decode_attend(q, k, v, positions, cache)
        else:
            out = self._self_attend(q, k, v)
        out = self.o_proj(out.reshape(B, S, H * D))
        return out if self.tp is None else self.tp.leave(out)

    def _self_attend(self, q, k, v):
        """Causal self-attention over the incoming tokens only: the train
        forward, and the decode path's prefill (a fresh cache's prompt sits at
        positions [0, S), so attention over the prompt alone is the full
        causal attention). Returns [B,S,H,D]."""
        cfg = self.cfg
        B, S, H, D = q.shape
        K = k.shape[2]
        if cfg.attn_impl == "flash":
            return flash_attention(q, k, v, causal=True)
        qg = q.view(B, S, K, H // K, D)
        scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / math.sqrt(D)
        causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        return torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, H, D)

    def _decode_attend(self, q, k, v, positions, cache):
        """Write the incoming tokens' K/V into the layer's cache slabs
        ``[B, K, L, D]`` IN PLACE (the caller's tensors change; no copy of
        the slab is made), then attend: prefill (S > 1, ``prefill_mode="self"``)
        over the incoming tokens, otherwise against the full cache. Under
        ``kv_quantize="int8"`` each token's K and V are quantized per kv head
        over ``head_dim`` and written with their scales ``[B, K, L, 1]``."""
        self.write_cache(k, v, positions, cache)
        if q.shape[1] > 1 and self.cfg.prefill_mode == "self":
            # Over the incoming, unquantized k and v.
            return self._self_attend(q, k, v)
        return self._cache_attend(q, positions, cache)

    def write_cache(self, k, v, positions, cache) -> None:
        """Write k and v ``[B, S, K, D]`` at ``positions`` into the layer's
        slabs, in place."""
        cfg = self.cfg
        k_in = k.transpose(1, 2).to(cfg.dtype)  # [B, K, S, D]
        v_in = v.transpose(1, 2).to(cfg.dtype)
        if cfg.kv_quantize == "int8":
            kq, vq = quantize(k_in, -1), quantize(v_in, -1)
            writes = {
                "cached_key": kq.q, "key_scale": kq.scale,
                "cached_value": vq.q, "value_scale": vq.scale,
            }
        else:
            writes = {"cached_key": k_in, "cached_value": v_in}
        rows = torch.arange(k.shape[0], device=k.device)[:, None] if cfg.decode_per_row else None
        for name, vals in writes.items():
            if cfg.decode_per_row:
                # Each row writes at its own positions[b, :].
                cache[name][rows, :, positions] = vals.transpose(1, 2)
            else:
                # Batch-uniform: every row at row 0's offsets (positions[0, 0] on).
                cache[name].index_copy_(2, positions[0], vals)

    def _cache_attend(self, q, positions, cache):
        """q against the FULL cache with a per-(row, token) position-validity
        mask col <= row. Returns [B,S,H,D]. An int8 cache is only converted;
        its scales fold into the scores (K) and into the probabilities (V,
        rounded to ``cfg.dtype`` again), in the reference's order."""
        cfg = self.cfg
        ck, cv = cache["cached_key"], cache["cached_value"]
        kv8 = cfg.kv_quantize == "int8"
        B, S, H, D = q.shape
        K, L = cfg.n_kv_heads, ck.shape[2]
        qg = q.view(B, S, K, H // K, D)
        scores = torch.einsum("bskgd,bktd->bkgst", qg.float(), ck.float()) / math.sqrt(D)
        if kv8:
            scores = scores * cache["key_scale"].squeeze(-1)[:, :, None, None, :]
        col = torch.arange(L, device=q.device)[None, None, :]  # [1,1,L]
        row = positions[:, :, None]  # [B,S,1]
        valid = (col <= row)[:, None, None, :, :]  # [B,1,1,S,L]
        scores = scores.masked_fill(~valid, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        if kv8:
            probs = (probs * cache["value_scale"].squeeze(-1)[:, :, None, None, :]).to(cfg.dtype)
            cv = cv.to(cfg.dtype)
        return torch.einsum("bkgst,bktd->bskgd", probs, cv).reshape(B, S, H, D)


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)); under ``tp`` over this rank's
    ``d_ff/tp`` columns."""

    def __init__(self, cfg: LlamaConfig, device=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.tp = tp
        d_ff = _local(cfg.d_ff, tp, "d_ff")
        self.gate_proj = _Linear(cfg.d_model, d_ff, cfg, device)
        self.up_proj = _Linear(cfg.d_model, d_ff, cfg, device)
        self.down_proj = _Linear(d_ff, cfg.d_model, cfg, device)

    def forward(self, x):
        if self.tp is not None:
            x = self.tp.enter(x)
        out = self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return out if self.tp is None else self.tp.leave(out)


class MoEMLP(nn.Module):
    """Top-k mixture-of-experts feed-forward (``parallel/moe.py``) on this
    one device: dense dispatch (``moe_mlp_reference``) or capacity-factor
    sparse dispatch (``moe_mlp_sparse``).

    Parameters in the reference's layout and names, in ``cfg.param_dtype``:
    the router ``gate`` [D, E], used as stored (the router computes in f32),
    and the expert banks ``w_in`` [E, D, F] and ``w_out`` [E, F, D], cast to
    ``cfg.dtype`` at the call. Under ``cfg.quantize`` each bank is an int8
    tensor with an f32 scale a column (``w_in_scale`` [E, 1, F],
    ``w_out_scale`` [E, 1, D]), dequantized at the call; the router stays
    full precision."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.gate = nn.Parameter(torch.empty((D, E), dtype=cfg.param_dtype, device=device))
        for name, shape in (("w_in", (E, D, Fd)), ("w_out", (E, Fd, D))):
            if cfg.quantize:
                q = torch.zeros(shape, dtype=torch.int8, device=device)
                scale = torch.ones(shape[:-2] + (1, shape[-1]), device=device)
                self.register_parameter(name, nn.Parameter(q, requires_grad=False))
                self.register_parameter(scale_name(name), nn.Parameter(scale, requires_grad=False))
            else:
                w = torch.empty(shape, dtype=cfg.param_dtype, device=device)
                self.register_parameter(name, nn.Parameter(w))

    def _bank(self, name: str) -> torch.Tensor:
        w = getattr(self, name)
        if self.cfg.quantize:
            return dequantize(w, getattr(self, scale_name(name)), self.cfg.dtype)
        return w.to(self.cfg.dtype)

    def forward(self, x, want_aux: bool = False):
        """``(out, aux)``: the layer's output in ``x``'s shape and dtype, and
        its load-balance loss when ``want_aux`` and ``cfg.moe_aux_weight > 0``
        (else None)."""
        cfg = self.cfg
        params = {"gate": self.gate, "w_in": self._bank("w_in"), "w_out": self._bank("w_out")}
        x2d = x.reshape(-1, cfg.d_model)
        aux = None
        if want_aux and cfg.moe_aux_weight > 0:
            aux = load_balance_loss(params, x2d, cfg.moe_top_k)
        if cfg.moe_dispatch == "sparse":
            out = moe_mlp_sparse(
                params, x2d, top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor
            )
        else:
            out = moe_mlp_reference(params, x2d, top_k=cfg.moe_top_k)
        return out.reshape(x.shape).to(x.dtype), aux


class Block(nn.Module):
    """Pre-norm decoder block: attention, then the MLP (``mlp``) or, with
    ``cfg.n_experts > 0``, the mixture of experts (``moe_mlp``). Returns
    ``(x, aux)``, aux the MoE layer's load-balance loss when asked for
    (``want_aux``), else None."""

    def __init__(self, cfg: LlamaConfig, device=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.attn = Attention(cfg, device, tp)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.moe = cfg.n_experts > 0
        if self.moe:
            self.moe_mlp = MoEMLP(cfg, device)
        else:
            self.mlp = MLP(cfg, device, tp)

    def forward(self, x, positions, cache=None, want_aux: bool = False):
        x = x + self.attn(self.attn_norm(x), positions, cache)
        h = self.mlp_norm(x)
        if self.moe:
            out, aux = self.moe_mlp(h, want_aux)
            return x + out, aux
        return x + self.mlp(h), None


class Llama(nn.Module):
    """Decoder-only LM: tokens [B,S] → logits [B,S,vocab] (f32).

    ``return_hidden=True`` returns the final-norm hidden states [B,S,D]
    instead of applying the LM head. With ``cfg.decode`` the forward needs a
    cache (see :func:`decode_forward`). ``tp`` builds this rank's part of a
    tensor-parallel model (the module docstring).
    """

    def __init__(self, cfg: LlamaConfig, device=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        if tp is not None:
            for what, refused in (
                ("decoding (generate and serve take no mesh, as in JAX)", cfg.decode),
                ("int8 weights", bool(cfg.quantize)),
                ("the mixture of experts (ROADMAP.md item 3c-2)", cfg.n_experts > 0),
            ):
                if refused:
                    raise NotImplementedError(f"a tensor-parallel Llama does not run {what}")
            check_tp_divides(cfg, tp.size)
        self.cfg = cfg
        self.tp = tp
        V = _local(cfg.vocab_size, tp, "vocab_size")
        # The first vocabulary id of this rank's rows of the embedding and
        # columns of the head.
        self.vocab_offset = 0 if tp is None else tp.index * V
        self.embed = nn.Embedding(V, cfg.d_model, device=device, dtype=cfg.param_dtype)
        self.layers = nn.ModuleList(Block(cfg, device, tp) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.lm_head = nn.Linear(cfg.d_model, V, bias=False, device=device, dtype=cfg.param_dtype)
        if cfg.quantize:
            _hold_int8(self.embed)
            _hold_int8(self.lm_head)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Llama":
        """Random init with flax's distributions: lecun_normal (truncated
        normal, fan-in scaled) for matmul kernels, normal(1.0) for the
        embedding, ones for the norms. Draws in f32 on ``generator``'s
        device, one tensor at a time, then copies into the parameter: one
        seed gives the same weights to a model on the host as on the card
        when both draw with the card's generator. A tensor-parallel model
        draws each whole tensor and keeps its block, so that its ranks
        together hold the one-process init."""
        if self.cfg.quantize:
            raise ValueError(
                "a quantize-mode model cannot init: init the full-precision "
                "model and quantize its state dict with "
                "ops.quantize.quantize_state_dict"
            )
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
                continue
            dim = tp_dim(name) if self.tp is not None else None
            shape = list(p.shape)
            if dim is not None:
                shape[dim] *= self.tp.size
            w = torch.empty(shape, dtype=torch.float32, device=generator.device)
            if name == "embed.weight":
                w.normal_(0.0, 1.0, generator=generator)
            else:
                # flax lecun_normal: variance 1/fan_in, truncated at 2 std,
                # std corrected for the truncation. The MoE parameters keep
                # the reference's [..., in, out] layout, whose fan-in counts
                # every axis but the last (the expert axis of a bank too);
                # an nn.Linear weight is [out, in].
                fan_in = w.numel() // w.shape[-1] if ".moe_mlp." in name else w.shape[1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            if dim is not None:
                w = w.narrow(dim, self.tp.index * p.shape[dim], p.shape[dim])
            p.copy_(w)
        return self

    @torch.no_grad()
    def cast_matmul_weights_(self) -> "Llama":
        """Hold the matmul weights and the embedding table in ``cfg.dtype``
        from now on (in place): a serving model pays the cast once at load
        instead of at every call. Norm scales, the MoE router and the LM head
        keep their dtype. Not for training: the optimizer would then update
        bf16 weights. int8 weights stay int8."""
        for name, p in self.named_parameters():
            if p.dtype == torch.int8:
                continue
            if name == "embed.weight" or name.endswith(
                ("_proj.weight", "moe_mlp.w_in", "moe_mlp.w_out")
            ):
                p.data = p.data.to(self.cfg.dtype)
        return self

    def head_kernel(self) -> torch.Tensor:
        """The LM-head weight as [D, V] (the JAX layout): in its parameter
        dtype, or dequantized to f32 from int8."""
        if self.cfg.quantize:
            return dequantize(self.lm_head.weight, self.lm_head.scale, torch.float32).t()
        return self.lm_head.weight.t()

    def forward(
        self, tokens, positions=None, *, cache=None, return_hidden: bool = False,
        return_aux: bool = False,
    ):
        """Logits (or hidden states), and with ``return_aux`` the pair
        ``(out, aux)``: aux the mean over layers of the MoE load-balance loss
        when the model has experts and ``cfg.moe_aux_weight > 0``, else None
        (the reference's ``losses`` collection, collected only when the loss
        asks for it)."""
        want_aux = return_aux and self.cfg.n_experts > 0 and self.cfg.moe_aux_weight > 0
        if positions is None:
            S = tokens.shape[-1]
            positions = torch.arange(S, device=tokens.device).expand(tokens.shape)
        positions = positions.long()  # cache writes index with it
        # Gather, then cast: the same values as flax's cast-then-gather
        # (nn.Embed(dtype=bf16) casts the whole table first). The backward
        # differs only in where it rounds: the rows of repeated tokens are
        # summed in the table's own dtype (f32 for training) and not in bf16.
        if self.cfg.quantize:
            # Gather the int8 rows and their scales, then dequantize the rows.
            x = dequantize(
                F.embedding(tokens, self.embed.weight),
                F.embedding(tokens, self.embed.scale),
                self.cfg.dtype,
            )
        elif self.tp is not None:
            # Vocab-parallel: this rank's rows, zeros for the others' ids,
            # summed over tp.
            local = tokens - self.vocab_offset
            mine = (local >= 0) & (local < self.embed.weight.shape[0])
            x = F.embedding(local.clamp(0, self.embed.weight.shape[0] - 1), self.embed.weight)
            x = self.tp.leave(torch.where(mine[..., None], x, 0).to(self.cfg.dtype))
        else:
            x = F.embedding(tokens, self.embed.weight).to(self.cfg.dtype)
        auxes = []
        if self.cfg.remat and cache is None and torch.is_grad_enabled():
            context_fn = remat_policy(self.cfg) or noop_context_fn
            for block in self.layers:
                x, aux = checkpoint(
                    block, x, positions, None, want_aux, use_reentrant=False, context_fn=context_fn
                )
                auxes.append(aux)
        else:
            for i, block in enumerate(self.layers):
                layer_cache = None if cache is None else cache[f"layer_{i}"]["attn"]
                x, aux = block(x, positions, layer_cache, want_aux)
                auxes.append(aux)
        x = self.final_norm(x)
        if self.tp is not None and not return_hidden:
            raise ValueError(
                "a tensor-parallel Llama returns hidden states (return_hidden=True); its loss is "
                "ops.chunked_xent.vocab_parallel_xent over the head's blocks"
            )
        if return_hidden:
            out = x
        else:
            if self.cfg.quantize:
                head = dequantize(self.lm_head.weight, self.lm_head.scale, torch.float32)
            else:
                head = self.lm_head.weight.float()
            out = F.linear(x.float(), head)
        if return_aux:
            return out, torch.stack(auxes).mean() if want_aux else None
        return out


def init_decode_cache(cfg: LlamaConfig, batch: int, device=None):
    """Zero KV cache for :func:`decode_forward`: a flat per-layer dict
    (``layer_0`` .. ``layer_{n-1}``), each ``{"attn": {"cached_key",
    "cached_value"}}`` with slabs ``[B, K, max_decode_len, D]`` in
    ``cfg.dtype``; under ``kv_quantize="int8"`` the slabs are int8 and each
    layer adds ``key_scale``/``value_scale`` ``[B, K, max_decode_len, 1]`` in
    f32. The slabs are written in place by every forward."""
    shape = (batch, cfg.n_kv_heads, cfg.max_decode_len, cfg.head_dim)
    kv8 = cfg.kv_quantize == "int8"

    def slab():
        s = {
            name: torch.zeros(shape, dtype=torch.int8 if kv8 else cfg.dtype, device=device)
            for name in ("cached_key", "cached_value")
        }
        if kv8:
            for name in ("key_scale", "value_scale"):
                s[name] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device)
        return s

    return {f"layer_{i}": {"attn": slab()} for i in range(cfg.n_layers)}


def decode_forward(model: Llama, cache, tokens, positions=None, *, return_hidden: bool = True):
    """The serving forward over a :func:`init_decode_cache` cache.

    ``model.cfg.decode`` must be True. Each layer writes the incoming
    tokens' K/V into its slab in place and attends (prefill over the prompt,
    decode steps against the cache). Returns ``(hidden_or_logits, cache)``;
    the returned cache is the same dict, updated in place.
    """
    if not model.cfg.decode:
        raise ValueError("decode_forward needs a model built with decode=True")
    if getattr(model, "tp", None) is not None:
        raise NotImplementedError("decoding a tensor-parallel Llama (generate and serve take no mesh)")
    if positions is not None:
        _debug_check_decode_positions(positions, model.cfg)
    out = model(tokens, positions, cache=cache, return_hidden=return_hidden)
    return out, cache


def _debug_check_decode_positions(positions: torch.Tensor, cfg: LlamaConfig) -> None:
    """The ``TPUJOB_DEBUG_CHECKS`` assert on decode positions, per the
    config's contract (the JAX package's check of the same name):

    - always: rows are per-row CONTIGUOUS (pos[b, s] = pos[b, 0] + s) and
      every write lands inside the cache (pos < max_decode_len);
    - ``decode_per_row=False``: batch-uniform (the cache write offset reads
      row 0);
    - ``prefill_mode="self"``: multi-token inputs start at position 0
      (self-attention prefill would silently drop earlier context at a
      nonzero start; chunked continuations need prefill_mode="cache").

    No-op unless the env var is set: it copies the positions to the host,
    a device sync per call."""
    if os.environ.get("TPUJOB_DEBUG_CHECKS", "").lower() in ("", "0", "false", "no"):
        return
    pos = positions.detach().cpu()
    S = pos.shape[-1]
    if not bool((pos == pos[:, :1] + torch.arange(S)).all()):
        raise ValueError(f"decode positions must be contiguous per row; got {pos}")
    if not cfg.decode_per_row and not bool((pos == pos[0:1]).all()):
        raise ValueError(
            "decode positions must be batch-uniform (unpadded equal-length "
            f"batch); got rows {pos}. Bucket ragged prompts to equal length, "
            "generate row-by-row, or build the model with decode_per_row=True "
            "(serving engine)."
        )
    if int(pos.max()) >= cfg.max_decode_len:
        raise ValueError(
            f"decode position {int(pos.max())} >= max_decode_len "
            f"{cfg.max_decode_len}: the cache write would fault or corrupt the rollout"
        )
    if cfg.prefill_mode == "self" and S > 1 and bool((pos[:, 0] != 0).any()):
        raise ValueError(
            "multi-token decode input (prefill) must start at position 0, got "
            f"starts {pos[:, 0]}: prefill_mode='self' attends over the incoming "
            "tokens only. Chunked prefill needs prefill_mode='cache'."
        )
