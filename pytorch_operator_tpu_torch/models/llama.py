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
mixture of experts of ``parallel/moe.py`` (dense or capacity-factor sparse
dispatch); with ``moe_aux_weight > 0`` and
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

``mesh=`` (the world's ``DeviceMesh``) gives the model the mesh's other
model-parallel axes, as JAX's ``Llama(cfg, mesh=mesh)``:

- **ep** (``ExpertParallel``): each MoE layer holds its rank's ``E/ep``
  experts (and under tp each expert's ``d_ff/tp``), and runs
  ``moe_mlp``/``moe_mlp_sparse`` over the mesh, as the reference's
  ``MoEMLP`` picks (JAX l.654-672).
- **sp** (``SequenceParallel``) with ``attn_impl="ring"`` or ``"ulysses"``:
  the forward takes whole rows and computes this rank's block of ``S/sp``
  positions (:meth:`Llama.seq_block`) with their global positions; the
  attention is ``ring_attention_shard`` or ``ulysses_attention_shard`` over
  sp. Where sp does not divide S, or with no sp axis (no world), ring and
  ulysses run the dense f32 ``_single_shard`` over the whole sequence, as
  JAX's do; with another ``attn_impl`` every sp rank computes the whole
  sequence. Ulysses refuses a kv-head count that sp does not divide (JAX's
  error). Under tp, where sp does not divide a tp rank's ``n_kv_heads/tp``,
  ulysses gathers q, k and v over tp and swaps the global heads, as JAX's
  (whose ulysses sees the global heads), keeping this rank's of the output
  (``ulysses_attention_tp``).

- **pp** (``PipelineParallel``): the model is one stage of the pipeline
  (``parallel/pipeline.py``): layers ``[s·L/P, (s+1)·L/P)`` under their
  global state-dict names (``layers.<i>``; the other entries of
  ``layers`` are None), the embedding on stage 0, and, where P divides the
  vocabulary, the final norm on every stage and ``V/P`` head rows each
  (the vocab-parallel tail of JAX's 1F1B, for both schedules), else the
  final norm and the whole head on the last stage. It trains through
  :meth:`Llama.pp_value_and_grad` (:func:`train_value_and_grad_pp`) and
  evaluates through :meth:`Llama.pp_forward` (:func:`forward_pp`); its
  embedding, stage and tail are methods that ``shard_model`` registers as
  FSDP2 forward methods, so that FSDP2 gathers the root's parameters
  around them. JAX's refusals are
  kept (int8 weights, ``n_layers % pp``, ring or ulysses attention in the
  pipeline, a MoE aux loss). Beside tp, ep or sp a stage's layers are
  those axes' blocks, as outside the pipeline (sp with dense or flash
  attention: every sp rank computes the whole sequence); the head's
  ``V/P`` rows of a stage are cut again by tp (pp outer, tp inner:
  ``sharding.param_splits``; tp replicates them where it does not divide
  ``V/P``), the embedding on stage 0 is tp's vocab-parallel one, and the
  loss tail is vocab-parallel over tp and pp (:func:`_xent`). The ranks
  of a tp, ep or sp group share their pp coordinate, so they run the same
  ticks of the pipeline and post their collectives in the same order
  (``parallel/pipeline.py``).
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

from ..ops.chunked_xent import chunked_softmax_xent, vocab_parallel_xent
from ..ops.flash_attention import flash_attention
from ..ops.quantize import dequantize, quantize, scale_name
from ..parallel.collectives import all_gather, axis_size, broadcast, psum
from ..parallel.moe import TokenSplit, load_balance_loss, moe_mlp, moe_mlp_reference, moe_mlp_sparse
from ..parallel.pipeline import pipeline_apply, pipeline_value_and_grad
from ..parallel.ring import _single_shard, ring_attention_shard
from ..parallel.sharding import (
    ExpertParallel,
    PipelineParallel,
    SequenceParallel,
    TensorParallel,
    check_tp_divides,
    cut_splits,
    local_tensor,
    model_splits,
    take_block,
)
from ..parallel.ulysses import check_kv_heads, ulysses_attention_tp
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
        if self.attn_impl not in ("dense", "flash", "ring", "ulysses"):
            raise ValueError(
                f"attn_impl={self.attn_impl!r} not in ('dense', 'flash', 'ring', 'ulysses')"
            )
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
    """Grouped-query attention with RoPE; self-attention (flash, dense, or
    the sequence-parallel ring and ulysses over ``sp``) or, with
    ``cfg.decode``, KV-cache attention. Under ``tp`` it holds and attends
    this rank's heads (``n_heads/tp`` and ``n_kv_heads/tp``)."""

    def __init__(self, cfg: LlamaConfig, device=None, tp: Optional[TensorParallel] = None,
                 sp: Optional[SequenceParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.sp = sp
        H, K, D = _local(cfg.n_heads, tp, "n_heads"), _local(cfg.n_kv_heads, tp, "n_kv_heads"), cfg.head_dim
        if cfg.attn_impl == "ulysses" and sp is not None:
            check_kv_heads(cfg.n_kv_heads, sp.size)
        self.n_heads, self.n_kv_heads = H, K
        self.q_proj = _Linear(cfg.d_model, H * D, cfg, device)
        self.k_proj = _Linear(cfg.d_model, K * D, cfg, device)
        self.v_proj = _Linear(cfg.d_model, K * D, cfg, device)
        self.o_proj = _Linear(H * D, cfg.d_model, cfg, device)

    def forward(self, x, positions, cache: Optional[Dict[str, torch.Tensor]] = None,
                seq_split: bool = False):
        """``seq_split``: ``x`` is this rank's block of the sequence over sp
        (``positions`` its global positions)."""
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
        elif cfg.attn_impl in ("ring", "ulysses"):
            out = self._sp_attend(q, k, v, positions, seq_split)
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

    def _sp_attend(self, q, k, v, positions, seq_split: bool):
        """Ring or ulysses attention (``parallel/ring.py``,
        ``parallel/ulysses.py``), as JAX's l.350-368 dispatch: over sp on
        this rank's block when the sequence is split, else the dense f32
        single-shard path over the whole sequence. Returns [B,S,H,D]."""
        B, S, H, D = q.shape
        K = k.shape[2]
        qg = q.view(B, S, K, H // K, D)
        mesh = self.sp.mesh if self.sp is not None else None
        if not seq_split:
            out = _single_shard(qg, k, v, positions, causal=True)
        elif self.cfg.attn_impl == "ring":
            out = ring_attention_shard(qg, k, v, positions, positions, mesh=mesh)
        else:
            # The mask needs the whole rows' positions.
            full = all_gather(positions.t().contiguous(), "sp", mesh).t()
            out = ulysses_attention_tp(qg, k, v, full, mesh=mesh)
        return out.reshape(B, S, H, D)

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
    """Top-k mixture-of-experts feed-forward (``parallel/moe.py``): dense
    dispatch (``moe_mlp_reference``, or ``moe_mlp`` over the mesh) or
    capacity-factor sparse dispatch (``moe_mlp_sparse``). Under ``ep`` it
    holds this rank's ``E/ep`` experts, under ``tp`` each expert's
    ``d_ff/tp``; ``token_axes`` are the axes of ``mesh`` that may split the
    tokens (the data axes, and sp where the call's ``seq_split`` says it
    does): the load-balance loss takes its statistics over them, and sparse
    dispatch groups their tokens as the reference groups the global batch
    (``moe_mlp_sparse(tokens=)``).

    Parameters in the reference's layout and names, in ``cfg.param_dtype``:
    the router ``gate`` [D, E], used as stored (the router computes in f32),
    and the expert banks ``w_in`` [E, D, F] and ``w_out`` [E, F, D], cast to
    ``cfg.dtype`` at the call. Under ``cfg.quantize`` each bank is an int8
    tensor with an f32 scale a column (``w_in_scale`` [E, 1, F],
    ``w_out_scale`` [E, 1, D]), dequantized at the call; the router stays
    full precision."""

    def __init__(self, cfg: LlamaConfig, device=None, tp: Optional[TensorParallel] = None,
                 ep: Optional[ExpertParallel] = None, mesh=None, token_axes=()):
        super().__init__()
        self.cfg = cfg
        if ep is not None and cfg.n_experts % ep.size:
            raise ValueError(f"experts {cfg.n_experts} not divisible by ep={ep.size}")
        # The mesh the experts' parts are summed over (None: all of them
        # here), and the one the tokens are split over.
        self.mesh = mesh if (ep is not None or tp is not None) else None
        self.token_mesh, self.token_axes = (mesh, tuple(token_axes)) if token_axes else (None, ())
        E, D, Fd = _local(cfg.n_experts, ep, "n_experts"), cfg.d_model, _local(cfg.d_ff, tp, "d_ff")
        self.gate = nn.Parameter(torch.empty((D, cfg.n_experts), dtype=cfg.param_dtype, device=device))
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

    def forward(self, x, want_aux: bool = False, seq_split: bool = False):
        """``(out, aux)``: the layer's output in ``x``'s shape and dtype, and
        its load-balance loss when ``want_aux`` and ``cfg.moe_aux_weight > 0``
        (else None). ``x`` [b, s, D] holds this rank's rows, and with
        ``seq_split`` its sp block of each row."""
        cfg = self.cfg
        params = {"gate": self.gate, "w_in": self._bank("w_in"), "w_out": self._bank("w_out")}
        x2d = x.reshape(-1, cfg.d_model)
        # An sp rank that computes the whole sequence holds no block of it.
        axes = tuple(a for a in self.token_axes if a != "sp" or seq_split)
        aux = None
        if want_aux and cfg.moe_aux_weight > 0:
            aux = load_balance_loss(params, x2d, cfg.moe_top_k, mesh=self.token_mesh,
                                    token_axes=axes)
        if cfg.moe_dispatch == "sparse":
            S = x.shape[1] * (axis_size("sp", self.token_mesh) if "sp" in axes else 1)
            out = moe_mlp_sparse(
                params, x2d, top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                mesh=self.mesh, tokens=TokenSplit(axes, x.shape[0], S, self.token_mesh),
            )
        elif self.mesh is not None:
            out = moe_mlp(params, x2d, mesh=self.mesh, top_k=cfg.moe_top_k)
        else:
            out = moe_mlp_reference(params, x2d, top_k=cfg.moe_top_k)
        return out.reshape(x.shape).to(x.dtype), aux


class Block(nn.Module):
    """Pre-norm decoder block: attention, then the MLP (``mlp``) or, with
    ``cfg.n_experts > 0``, the mixture of experts (``moe_mlp``). Returns
    ``(x, aux)``, aux the MoE layer's load-balance loss when asked for
    (``want_aux``), else None."""

    def __init__(self, cfg: LlamaConfig, device=None, tp: Optional[TensorParallel] = None,
                 ep: Optional[ExpertParallel] = None, sp: Optional[SequenceParallel] = None,
                 mesh=None, token_axes=()):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.attn = Attention(cfg, device, tp, sp)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.moe = cfg.n_experts > 0
        if self.moe:
            self.moe_mlp = MoEMLP(cfg, device, tp, ep, mesh, token_axes)
        else:
            self.mlp = MLP(cfg, device, tp)

    def forward(self, x, positions, cache=None, want_aux: bool = False, seq_split: bool = False):
        x = x + self.attn(self.attn_norm(x), positions, cache, seq_split)
        h = self.mlp_norm(x)
        if self.moe:
            out, aux = self.moe_mlp(h, want_aux, seq_split)
            return x + out, aux
        return x + self.mlp(h), None


class Llama(nn.Module):
    """Decoder-only LM: tokens [B,S] → logits [B,S,vocab] (f32).

    ``return_hidden=True`` returns the final-norm hidden states [B,S,D]
    instead of applying the LM head. With ``cfg.decode`` the forward needs a
    cache (see :func:`decode_forward`). ``tp`` builds this rank's part of a
    tensor-parallel model, ``mesh`` the model's part on that mesh (its tp
    axis when ``tp`` is not given, its ep and sp axes: the module
    docstring).
    """

    def __init__(self, cfg: LlamaConfig, device=None, tp: Optional[TensorParallel] = None,
                 mesh=None):
        super().__init__()
        if tp is None:
            tp = TensorParallel.of(mesh)
        ep, sp, pp = ExpertParallel.of(mesh), SequenceParallel.of(mesh), PipelineParallel.of(mesh)
        if mesh is None and tp is not None:
            mesh = tp.mesh
        if pp is not None:
            check_pp(cfg, pp.size)
        for ax, kind in ((tp, "tensor-parallel"), (ep, "expert-parallel"), (sp, "sequence-parallel"),
                         (pp, "pipeline-parallel")):
            if ax is None:
                continue
            for what, refused in (
                ("decoding (generate and serve take no mesh, as in JAX)", cfg.decode),
                ("int8 weights", bool(cfg.quantize)),
            ):
                if refused:
                    raise NotImplementedError(f"a {kind} Llama does not run {what}")
        if tp is not None:
            check_tp_divides(cfg, tp.size)
        self.cfg = cfg
        self.tp, self.ep, self.sp, self.pp = tp, ep, sp, pp
        # The axes that may split the tokens (the MoE layers').
        sizes = {} if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        self.mesh_axes = sizes
        # Inside the pipeline sp never splits the sequence (ring and ulysses
        # are refused there, check_pp; a stage's MoE layers get no
        # seq_split): a stage's sparse groups span the data axes' shares of
        # a pp microbatch, the global batch's microbatch as JAX's.
        token_axes = tuple(a for a in ("dp", "fsdp", "sp") if sizes.get(a, 1) > 1)
        # The axes whose blocks the head's vocabulary rows are, innermost
        # first (sharding.param_splits: a pp stage's V/P rows, cut again by
        # tp where it divides them), and the first vocabulary id of this
        # rank's head rows: stage s, tp rank t at s·V/P + t·V/(P·tp). The
        # embedding's rows are tp's blocks of the whole vocabulary.
        V = cfg.vocab_size
        self.head_axes = [ax for ax, _ in cut_splits(model_splits(self, "lm_head.weight"))]
        self.vocab_offset = 0
        for ax in reversed(self.head_axes):
            V //= ax.size
            self.vocab_offset += ax.index * V
        self.embed_offset = 0 if tp is None else tp.index * (cfg.vocab_size // tp.size)
        # This rank's layers (a pp stage's), and whether it holds the
        # embedding and the tail (final norm and head).
        self.layer_ids = range(cfg.n_layers) if pp is None else pp.layers(cfg.n_layers)
        first = pp is None or pp.index == 0
        tail = pp is None or pp.holds_tail(cfg.vocab_size)
        self.embed = nn.Embedding(_local(cfg.vocab_size, tp, "vocab_size"), cfg.d_model, device=device,
                                  dtype=cfg.param_dtype) if first else None
        self.layers = nn.ModuleList(
            Block(cfg, device, tp, ep, sp, mesh, token_axes) if i in self.layer_ids else None
            for i in range(cfg.n_layers)
        )
        self.final_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device) if tail else None
        self.lm_head = nn.Linear(cfg.d_model, V, bias=False, device=device,
                                 dtype=cfg.param_dtype) if tail else None
        if cfg.quantize:
            _hold_int8(self.embed)
            _hold_int8(self.lm_head)

    @property
    def vocab_parallel(self) -> bool:
        """A pp stage holding ``V/P`` head rows (P divides the vocabulary)."""
        return self.pp is not None and self.pp.vocab_parallel(self.cfg.vocab_size)

    def whole(self) -> "Llama":
        """One process's model of this config on the meta device: the whole
        of a pp stage's model, every stage's tensors in one process's
        order."""
        return Llama(self.cfg, device="meta")

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Llama":
        """Random init with flax's distributions: lecun_normal (truncated
        normal, fan-in scaled) for matmul kernels, normal(1.0) for the
        embedding, ones for the norms. Draws in f32 on ``generator``'s
        device, one tensor at a time, then copies into the parameter: one
        seed gives the same weights to a model on the host as on the card
        when both draw with the card's generator. A tensor- or
        expert-parallel model draws each whole tensor and keeps its block,
        and a pp stage draws every tensor and keeps its own, so that the
        ranks together hold the one-process init."""
        if self.cfg.quantize:
            raise ValueError(
                "a quantize-mode model cannot init: init the full-precision "
                "model and quantize its state dict with "
                "ops.quantize.quantize_state_dict"
            )
        mine = dict(self.named_parameters())
        # A pp stage draws every tensor of the whole model in order (the
        # generator's sequence is one process's) and keeps its own.
        whole = self.whole() if self.pp is not None else self
        for name, ref in whole.named_parameters():
            p = mine.get(name)
            if name.endswith("norm.weight"):
                if p is not None:
                    p.fill_(1.0)
                continue
            splits = model_splits(self, name)
            shape = list(ref.shape)
            if whole is self:
                for ax, d in cut_splits(splits):
                    shape[d] *= ax.size
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
            if p is None:
                continue
            p.copy_(take_block(w, splits))
        return self

    def seq_block(self, S: int):
        """``(offset, length)`` of the block of a length-``S`` sequence this
        rank computes over sp, or None when it computes the whole sequence
        (no sp axis, an ``attn_impl`` other than ring and ulysses, or S % sp
        != 0)."""
        sp = self.sp
        if sp is None or self.cfg.attn_impl not in ("ring", "ulysses") or S % sp.size:
            return None
        n = S // sp.size
        return sp.index * n, n

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
        asks for it).

        Over sp (:meth:`seq_block`) ``tokens`` and ``positions`` are whole
        rows, and the output is this rank's block of positions."""
        if self.pp is not None:
            raise ValueError(
                "a pipeline-parallel Llama holds one stage: run it through pp_forward and "
                "pp_value_and_grad"
            )
        want_aux = return_aux and self.cfg.n_experts > 0 and self.cfg.moe_aux_weight > 0
        S = tokens.shape[-1]
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(tokens.shape)
        positions = positions.long()  # cache writes index with it
        span = self.seq_block(S) if cache is None else None
        if span is not None:
            off, n = span
            tokens, positions = tokens[:, off:off + n], positions[:, off:off + n]
        seq_split = span is not None
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
        else:
            x = self._embed(tokens)
        x, auxes = self.run_layers(x, positions, cache, want_aux, seq_split)
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

    # The pp stage's parts (_embed on stage 0, _pp_stage, _pp_head and
    # _pp_xent on the stages that hold the tail) are FSDP2 forward methods
    # (PP_FORWARD_METHODS, registered by shard_model): FSDP2 gathers the
    # root's parameters around each and reduces their gradients after its
    # backward.
    def _embed(self, tokens):
        if self.tp is None:
            return F.embedding(tokens, self.embed.weight).to(self.cfg.dtype)
        # Vocab-parallel: this rank's rows, zeros for the others' ids,
        # summed over tp.
        n = self.embed.weight.shape[0]
        local = tokens - self.embed_offset
        mine = (local >= 0) & (local < n)
        x = F.embedding(local.clamp(0, n - 1), self.embed.weight)
        return self.tp.leave(torch.where(mine[..., None], x, 0).to(self.cfg.dtype))

    def run_layers(self, x, positions, cache=None, want_aux: bool = False, seq_split: bool = False):
        """``x`` through this model's layers (a pp stage's own), each under
        ``torch.utils.checkpoint`` when ``cfg.remat`` and training. Returns
        ``(x, auxes)``, each layer's MoE aux (or None)."""
        auxes = []
        remat = self.cfg.remat and cache is None and torch.is_grad_enabled()
        context_fn = (remat_policy(self.cfg) or noop_context_fn) if remat else None
        for i in self.layer_ids:
            block = self.layers[i]
            if remat:
                x, aux = checkpoint(
                    block, x, positions, None, want_aux, seq_split, use_reentrant=False,
                    context_fn=context_fn,
                )
            else:
                layer_cache = None if cache is None else cache[f"layer_{i}"]["attn"]
                x, aux = block(x, positions, layer_cache, want_aux, seq_split)
            auxes.append(aux)
        return x, auxes

    def _pp_stage(self, act):
        """A pp stage: ``act`` [b, S, D] through this stage's layers. Its tp
        and ep collectives (``tp_enter``/``tp_leave``, the experts' sums) and
        sparse dispatch's gather of the top-k indices over the data axes run
        inside the tick, forward, in the stored graph's backward and in a
        remat's recompute: every rank of a tp, ep or data group holds the
        same pp index, so all of them run this call at the same ticks on
        their shares of the same microbatch."""
        positions = torch.arange(act.shape[1], device=act.device).expand(act.shape[:2])
        return self.run_layers(act, positions)[0]

    def pp_forward(self, tokens, *, microbatches: int, return_hidden: bool = False):
        """The pipeline forward (the hook the trainer's loss calls on a pp
        mesh): :func:`forward_pp`."""
        return forward_pp(self, tokens, microbatches=microbatches, return_hidden=return_hidden)

    def pp_value_and_grad(self, tokens, *, microbatches: int, schedule: str = "1f1b"):
        """The pipeline's loss and gradients (the trainer's hook for a pp
        step): :func:`train_value_and_grad_pp`."""
        return train_value_and_grad_pp(self, tokens, microbatches=microbatches, schedule=schedule)

    def _pp_head(self, y, return_hidden: bool = False):
        """The pipeline's output ``y`` through the final norm and, unless
        ``return_hidden``, this stage's head rows as f32 logits."""
        h = self.final_norm(y)
        return h if return_hidden else F.linear(h.float(), self.lm_head.weight.float())

    def _pp_xent(self, y, tokens, norm: bool = True):
        """:func:`_xent` of the pipeline's output ``y`` (``norm``: through the
        final norm first; else ``y`` is already normed) against ``tokens``."""
        return _xent(self, self.final_norm(y) if norm else y, tokens)

    def pp_xent(self, hidden, tokens):
        """The mean next-token cross-entropy of :meth:`pp_forward`'s hidden
        states (None on a stage without the tail) against ``tokens``, the
        same on every stage: vocab-parallel over the stages' head rows, or
        the last stage's whole head's, broadcast."""
        pp = self.pp
        if self.vocab_parallel:
            return self._pp_xent(hidden, tokens, norm=False)
        if pp.index == pp.size - 1:
            loss = self._pp_xent(hidden, tokens, norm=False).float()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return broadcast(loss, "pp", pp.mesh, src=pp.size - 1)


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


# The methods of a pp stage that run as calls of the model under FSDP2.
PP_FORWARD_METHODS = ("_embed", "_pp_stage", "_pp_head", "_pp_xent")


def check_pp(cfg: LlamaConfig, n_stages: int) -> None:
    """JAX's refusals of a model that cannot run the pp pipeline (its
    ``_pp_parts``, l.1058-1071), with its messages."""
    if cfg.quantize:
        raise ValueError("quantize-mode params (inference) cannot run the pp pipeline")
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={n_stages}")
    if cfg.attn_impl in ("ring", "ulysses"):
        raise ValueError(f"attn_impl={cfg.attn_impl!r} cannot run inside the pp pipeline")


def _pp_parts(model: Llama):
    """The stage of JAX's ``_pp_parts``: ``stage(None, act)``, this stage's
    layers (each rematerialised under ``cfg.remat``) on ``act`` [b, S, D].
    (JAX regroups the scan-stacked layers into P stages here, and refuses
    what :func:`check_pp` refuses; a port stage holds its own layers, and
    its constructor ran :func:`check_pp`.)"""

    def stage(_, act):
        return model._pp_stage(act)

    return stage


def _pp_input(model: Llama, tokens):
    """The pipeline's input: stage 0's embedded tokens (with their graph
    when training), and on the other stages an empty tensor of that shape
    (they read only its shape and dtype)."""
    cfg = model.cfg
    if model.pp.index == 0:
        return model._embed(tokens)
    return torch.empty((), dtype=cfg.dtype, device=tokens.device).expand(*tokens.shape, cfg.d_model)


def forward_pp(model: Llama, tokens, *, microbatches: int, return_hidden: bool = False):
    """The pipeline-parallel forward (JAX l.1000-1044): the embedding on
    stage 0, the layers through ``parallel.pipeline.pipeline_apply`` over the
    mesh's ``pp`` axis (without autograd), then on each stage that holds the
    tail the final norm and, unless ``return_hidden``, the f32 logits of its
    head rows (its ``V/P`` vocabulary columns where P divides the
    vocabulary, else the last stage's whole head). None on a stage without
    the tail."""
    stage = _pp_parts(model)
    y = pipeline_apply(stage, None, _pp_input(model, tokens), mesh=model.pp.mesh, microbatches=microbatches)
    if model.final_norm is None:
        return None
    return model._pp_head(y, return_hidden)


def _xent(model: Llama, hidden, tokens):
    """The mean next-token cross-entropy of final-norm ``hidden`` [b, S, D]
    against ``tokens`` [b, S] over this stage's head: vocab-parallel over
    the axes that cut its rows (``model.head_axes``: tp inside the stage,
    then pp; ``chunked_vocab_stats`` in 8192-column chunks under
    ``xent_impl="chunked"``, one chunk of the rank's rows else, combined
    with one pmax and two psums an axis, tp's first), or the whole head's
    (chunked or dense f32 logits, as one process's loss). ``hidden``'s
    gradient is summed over tp here (``tp_enter``), as the tp model's head
    sums it; over pp it is this stage's part, which the pipeline sums."""
    cfg = model.cfg
    h = hidden[:, :-1].reshape(-1, cfg.d_model)
    labels = tokens[:, 1:].reshape(-1)
    w = model.head_kernel()
    if model.head_axes:
        if model.tp in model.head_axes:
            h = model.tp.enter(h)
        per = vocab_parallel_xent(h, w, labels, tp=model.head_axes, col_offset=model.vocab_offset,
                                  chunk=8192 if cfg.xent_impl == "chunked" else w.shape[1], enter=False)
    elif cfg.xent_impl == "chunked":
        per = chunked_softmax_xent(h, w, labels)
    else:
        return F.cross_entropy(F.linear(h.float(), model.lm_head.weight.float()), labels)
    return per.mean()


def train_value_and_grad_pp(model: Llama, tokens, *, microbatches: int, schedule: str = "1f1b"):
    """The pp train step's loss and gradients (JAX l.1105-1277): the
    embedding on stage 0, the layers through
    ``parallel.pipeline.pipeline_value_and_grad`` (``backward="stored"``),
    the final norm and the head's xent as its loss tail (:func:`_xent`, a
    call of the model): with ``sharded_loss`` where P divides the vocabulary
    (every stage's head rows over the last stage's output broadcast to all),
    else at the last stage; the embedding's gradient from the input
    cotangent the pipeline returns on stage 0. Returns the loss, the same on
    every stage; the gradients are left in ``.grad``, each the mean over the
    microbatches, the final norm's copies summed over the stages (each
    stage's loss chunk read its own copy) as JAX's ``reassemble`` sums them,
    so that the copies stay equal.

    Under FSDP2 each microbatch's backward keeps its gradients unreduced
    (``set_requires_gradient_sync(False)``) until this rank's last backward
    of the step, which reduces them all. Refused as in JAX: a MoE aux loss
    (``moe_aux_weight``); JAX's warning, where 1F1B's vocabulary does not
    divide, says that the tail runs on the last stage alone (JAX's runs
    replicated on every stage)."""
    cfg = model.cfg
    if getattr(cfg, "moe_aux_weight", 0.0):
        raise ValueError(
            "moe_aux_weight is not supported on a pp mesh (the pipeline "
            "path bypasses flax sow collections)"
        )
    pp = model.pp
    stage = _pp_parts(model)
    sharded = model.vocab_parallel
    if schedule == "1f1b" and pp.size > 1 and not sharded:
        import warnings

        # JAX's text up to where the port differs: its tail runs on the
        # last stage alone, not replicated on every stage.
        warnings.warn(
            f"vocab_size={cfg.vocab_size} does not divide pp={pp.size}: the pipeline "
            "loss tail cannot be vocab-parallel and will run on the last stage alone "
            "(the whole head there). Prefer a vocab/pp pairing that divides.",
            stacklevel=2,
        )
    fsdp = hasattr(model, "set_requires_gradient_sync")
    if fsdp:
        model.set_requires_gradient_sync(False)

    def last_backward():
        model.set_requires_gradient_sync(True)

    def loss_fn(_, y, tok):
        return model._pp_xent(y, tok)

    x = _pp_input(model, tokens)
    loss, (_, _, dx) = pipeline_value_and_grad(
        stage, loss_fn, None, None, x, tokens, mesh=pp.mesh, microbatches=microbatches,
        schedule=schedule, sharded_loss=sharded, backward="stored",
        on_last_backward=last_backward if fsdp and pp.index > 0 else None,
    )
    if pp.index == 0:
        if fsdp:
            last_backward()
        x.backward(dx)  # dx is the mean over the microbatches already
    for name, p in model.named_parameters():
        if p.grad is not None and name != "embed.weight":
            local_tensor(p.grad).div_(microbatches)
    if sharded:
        g = local_tensor(model.final_norm.weight.grad)
        g.copy_(psum(g, "pp", pp.mesh))
    return loss
