"""``loss_head_roofline``: the port's ``chunked_softmax_xent`` forward and
backward, called alone on the step's N = B·(S−1) bf16 hidden states against
an f32 [D, V] head, timed by CUDA events; the least work
(``flops.loss_head_least_work``: 6·N·D·V) over that time, as a share of the
card's roofline at the bf16 peak. Moves ``train_tokens_per_s``."""

import torch

from portbench import flops, timing


def read(run):
    if run.device.type != "cuda":
        return None
    from pytorch_operator_tpu_torch.ops.chunked_xent import chunked_softmax_xent

    cfg, mix = run.config, run.mix
    N, D, V = mix["batch"] * (mix["seq_len"] - 1), cfg["hidden_size"], cfg["vocab_size"]
    g = torch.Generator(device=run.device).manual_seed(0)
    hidden = torch.randn((N, D), generator=g, device=run.device).to(torch.bfloat16).requires_grad_(True)
    head = (torch.randn((V, D), generator=g, device=run.device) * D**-0.5).requires_grad_(True)
    labels = torch.randint(0, V, (N,), generator=g, device=run.device)

    def call():
        hidden.grad = head.grad = None
        chunked_softmax_xent(hidden, head.t(), labels).mean().backward()

    seconds = timing.seconds_per_call(call, warmup=1)
    return flops.roofline_pct(*flops.loss_head_least_work(N, D, V), seconds)
