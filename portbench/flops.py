"""The frozen yardstick: the chip's published peaks and the work each metric
counts, from the shapes alone.

- Model FLOPs of a training step (MFU): 6 · tokens · the matmul parameters
  of the blocks and the head (the embedding is a gather, not counted), plus
  attention at 3 × the causal forward, 2·B·S²·H·Dh a layer. Recompute is not
  counted: this is the work the step needs, not what the program dispatches.
- The attention layer's least work, forward and backward: 3 × the causal
  forward; bytes of q, k, v, o and do read once and o, dq, dk, dv written
  once, in bf16.
- The loss head's least work, forward and backward: 6·N·D·V (the logits,
  the hidden states' gradient, the head's gradient); bytes of the hidden
  states (bf16), the head (f32) and the labels (int64) once.

A roofline share is the least time, the larger of FLOPs over the bf16 peak
and bytes over the memory bandwidth, over the measured time. The bf16 peak
is used whatever precision the program computes in, so that a change of
precision cannot read over 100%.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def matmul_params(cfg: dict) -> int:
    """Parameters of the blocks' projections and MLP, and of the LM head."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    H, KH, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    layer = D * (H * Dh + 2 * KH * Dh) + H * Dh * D + 3 * D * F
    return cfg["num_hidden_layers"] * layer + cfg["vocab_size"] * D


def causal_attention_forward_flops(B: int, S: int, H: int, Dh: int) -> int:
    """q·kᵀ and p·v over the causal half: 2·B·S²·H·Dh."""
    return 2 * B * S * S * H * Dh


def step_model_flops(cfg: dict, batch: int, seq_len: int) -> dict:
    """``{"matmul", "attention", "total"}`` model FLOPs of one training step
    on ``batch`` rows of ``seq_len`` tokens."""
    matmul = 6 * batch * seq_len * matmul_params(cfg)
    attention = 3 * causal_attention_forward_flops(
        batch, seq_len, cfg["num_attention_heads"], cfg["head_dim"]
    ) * cfg["num_hidden_layers"]
    return {"matmul": matmul, "attention": attention, "total": matmul + attention}


def flash_least_work(B: int, S: int, H: int, KH: int, Dh: int) -> tuple:
    """``(flops, bytes)`` of one attention call, forward and backward."""
    flops = 3 * causal_attention_forward_flops(B, S, H, Dh)
    bf16 = 2
    q_like, kv_like = B * S * H * Dh * bf16, B * S * KH * Dh * bf16
    read = 2 * kv_like + 3 * q_like  # q, k, v, o, do
    written = 2 * q_like + 2 * kv_like  # o, dq, dk, dv
    return flops, read + written


def loss_head_least_work(N: int, D: int, V: int) -> tuple:
    """``(flops, bytes)`` of the loss head on ``N`` tokens, forward and
    backward."""
    return 6 * N * D * V, N * D * 2 + D * V * 4 + N * 8


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def roofline_pct(flops: float, nbytes: float, seconds: float) -> float:
    """The least time as a share of ``seconds``, in percent."""
    return 100.0 * least_seconds(flops, nbytes) / seconds


def mfu_pct(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS
