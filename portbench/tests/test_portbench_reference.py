"""The plain reference against the port at a tiny size on the CPU, in f32.

The port runs as the benchmark drives it (``harness.PortTrainer``: the
flash kernels' plain version, the chunked loss, AdamW); the reference draws
the same weights and takes the same tokens. A planted fault in the
reference (the rotary embedding dropped, the head in bf16) must fail the
same comparison.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from portbench import harness, reference, weights
from portbench.tests.conftest import tiny_cell

SEED = 2**31 + 5
# f32 on both sides; the two differ in summation order only.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-9


def _rel(a, b):
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30)).item()


def _gaps(cell):
    cfg, mix = cell.config, cell.mix
    cpu = torch.device("cpu")
    tokens = weights.tokens(cfg, mix, SEED, cpu)[0]

    prog = harness.PortTrainer(cfg, mix, SEED, cpu)
    from pytorch_operator_tpu_torch.workloads import trainer

    port_loss = trainer.make_lm_loss_fn(prog.model)(tokens)
    port_loss.backward()
    port_grads = {n: p.grad.detach().clone() for n, p in prog.named.items()}
    prog.optimizer.step()

    params = weights.draw(cfg, SEED, cpu)
    for p in params.values():
        p.requires_grad_(True)
    ref_loss = reference.loss(params, cfg, tokens)
    ref_loss.backward()
    grads = {n: p.grad for n, p in params.items()}
    # The reference's AdamW on the port's own gradients: the update alone.
    opt = cfg["assumed"]["optimizer"]
    start = weights.draw(cfg, SEED, cpu)
    for n, p in params.items():
        with torch.no_grad():
            p.copy_(start[n])
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        reference.adamw_(p, port_grads[n], m, v, 1, lr=opt["lr"], betas=tuple(opt["betas"]),
                         eps=opt["eps"], weight_decay=opt["weight_decay"])
    return {
        "loss": abs(port_loss.item() - ref_loss.item()) / abs(ref_loss.item()),
        "grad": max(_rel(port_grads[n], grads[n]) for n in grads),
        "param": max((prog.named[n].detach() - params[n].detach()).abs().max().item() for n in params),
    }


def test_reference_matches_the_port_in_f32(cell_name):
    g = _gaps(tiny_cell(cell_name, torch_dtype="float32"))
    assert g["loss"] < LOSS_RTOL, g
    assert g["grad"] < GRAD_RTOL, g
    assert g["param"] < PARAM_ATOL, g


def _no_rope(x, cos, sin):
    return x


def _head_bf16(h, w, labels, precision):
    logits = F.linear(h.bfloat16(), w.bfloat16()).float()
    return (torch.logsumexp(logits, -1) - logits.gather(1, labels[:, None])[:, 0]).sum()


@pytest.mark.parametrize("fault", ["rope_dropped", "head_bf16"])
def test_a_planted_fault_in_the_reference_fails_the_comparison(monkeypatch, fault):
    if fault == "rope_dropped":
        monkeypatch.setattr(reference, "rope", _no_rope)
    else:
        monkeypatch.setattr(reference, "_head_xent_sum", _head_bf16)
    g = _gaps(tiny_cell("mistral-7b.train.s32k", torch_dtype="float32"))
    assert g["loss"] > LOSS_RTOL or g["grad"] > GRAD_RTOL, g


def _dense_attention(q, k, v):
    B, S, H, Dh = q.shape
    G = H // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(Dh)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v)


def test_blocked_attention_matches_dense_forward_and_backward(monkeypatch):
    # Blocks of 3 query rows over S 10: a ragged last block and every diagonal case.
    monkeypatch.setattr(reference, "_BLOCK_ELEMS", 3 * 2 * 4 * 10)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 10, 4, 8, generator=g, dtype=torch.float64, requires_grad=True)
    k = torch.randn(2, 10, 2, 8, generator=g, dtype=torch.float64, requires_grad=True)
    v = torch.randn(2, 10, 2, 8, generator=g, dtype=torch.float64, requires_grad=True)
    do = torch.randn(2, 10, 4, 8, generator=g, dtype=torch.float64)
    got = reference._Attention.apply(q, k, v, "f32")
    grads = torch.autograd.grad(got, (q, k, v), do)
    want = _dense_attention(q, k, v)
    wgrads = torch.autograd.grad(want, (q, k, v), do)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for a, b in zip(grads, wgrads):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_fp8_control_rounds_products_and_keeps_shapes():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 16, generator=g, requires_grad=True)
    w = torch.randn(8, 16, generator=g, requires_grad=True)
    y = reference._linear(x, w, "fp8")
    y.sum().backward()
    exact = F.linear(x, w)
    err = _rel(y.detach(), exact.detach())
    assert 1e-3 < err < 0.2  # e4m3 keeps 3 mantissa bits
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
