"""``flash_attn_roofline``: the port's ``flash_attention`` forward and
backward through autograd, called alone at the cell's B, S, H, KH and Dh in
bf16, timed by CUDA events; the least work (``flops.flash_least_work``: 3 ×
the causal forward, each tensor read or written once) over that time, as a
share of the card's roofline. Moves ``train_tokens_per_s``."""

import torch

from portbench import flops, timing


def read(run):
    if run.device.type != "cuda":
        return None
    from pytorch_operator_tpu_torch.ops.flash_attention import flash_attention

    cfg, mix = run.config, run.mix
    B, S = mix["batch"], mix["seq_len"]
    H, KH, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    g = torch.Generator(device=run.device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=run.device, dtype=torch.bfloat16)

    q, k, v = randn(B, S, H, Dh), randn(B, S, KH, Dh), randn(B, S, KH, Dh)
    for t in (q, k, v):
        t.requires_grad_(True)
    do = randn(B, S, H, Dh)

    def call():
        q.grad = k.grad = v.grad = None
        flash_attention(q, k, v, causal=True).backward(do)

    seconds = timing.seconds_per_call(call)
    return flops.roofline_pct(*flops.flash_least_work(B, S, H, KH, Dh), seconds)
