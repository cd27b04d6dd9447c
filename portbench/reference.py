"""The plain reference of a Mistral-shaped decoder's training step.

Plain PyTorch, float32 throughout, with TF32 off for cuBLAS and cuDNN; it
imports nothing of the program under test and nothing of JAX. It follows
the published architecture (Mistral, as Hugging Face's ``MistralForCausalLM``
without a sliding window):

- token embedding, then per layer ``x += o(attn(rope(q(n1(x))),
  rope(k(n1(x))), v(n1(x))))`` and ``x += down(silu(gate(n2(x))) ·
  up(n2(x)))``, the norms RMSNorm with a learned scale;
- rotary embedding in the rotate-half layout, inverse frequencies
  ``theta^(-2i/Dh)``, angles computed in float64;
- grouped-query causal attention, softmax scale ``1/sqrt(Dh)``;
- a final RMSNorm and an untied head; the loss is the mean next-token
  cross-entropy over ``B·(S−1)`` positions;
- AdamW with decoupled weight decay on every parameter and bias correction,
  in the order of ``torch.optim.AdamW``'s single-tensor update.

So that a step at the benchmark's sizes fits beside nothing else on one
card, each layer runs under ``torch.utils.checkpoint``, attention is
computed in blocks of query rows with exact (not online) softmax and its
probabilities recomputed in the backward (:class:`_Attention`), and the loss
head in blocks of rows under checkpoint.

``precision="fp8"`` is the comparison's control: every product (the
projections, the MLP, attention's two products and the head) takes its
inputs rounded to float8 e4m3 with one scale a tensor, and the backward's
incoming gradients to e5m2; everything else stays float32.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import weights

# Elements of the largest transient block (attention probabilities, head
# logits): 2**28 f32 values, 1 GiB.
_BLOCK_ELEMS = 2**28


@dataclass
class Readings:
    """What a training run is judged by: each checked step's loss, the
    first step's gradient norm per parameter, and each parameter's change
    after the checked steps."""

    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS and cuDNN while the block runs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (a float8 type) with one scale for the
    tensor, back in float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8Linear(torch.autograd.Function):
    """``x @ wᵀ`` with e4m3 inputs; the backward's products take the e5m2
    gradient and the saved e4m3 inputs."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _round(x, torch.float8_e4m3fn), _round(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return F.linear(xq, wq)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _round(g, torch.float8_e5m2)
        dx = gq @ wq
        dw = gq.reshape(-1, gq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        return dx, dw


def _linear(x, w, precision: str):
    return F.linear(x, w) if precision == "f32" else _Fp8Linear.apply(x, w)


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(S: int, Dh: int, theta: float, device):
    """``(cos, sin)`` ``[S, Dh/2]`` f32, from float64 angles."""
    inv = theta ** (-torch.arange(0, Dh, 2, dtype=torch.float64, device=device) / Dh)
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x, cos, sin):
    """Rotate-half rotary embedding of ``x`` ``[B, S, heads, Dh]``."""
    half = x.shape[-1] // 2
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _probs(qb, kt, r0: int, n: int, G: int, scale: float, precision: str):
    """Softmax probabilities of query rows ``[r0, r0+n)`` (``qb`` ``[B, KH,
    G·n, Dh]``, the G query heads of a kv head stacked) against keys ``[0,
    r0+n)`` (``kt`` ``[B, KH, r0+n, Dh]``), causal: ``[B, KH, G·n, r0+n]``."""
    s = (qb @ kt.transpose(-1, -2)) * scale
    B, KH, _, T = s.shape
    s = s.view(B, KH, G, n, T)
    rows = torch.arange(r0, r0 + n, device=s.device)[:, None]
    cols = torch.arange(T, device=s.device)[None, :]
    s.masked_fill_(cols > rows, float("-inf"))
    p = torch.softmax(s, dim=-1).view(B, KH, G * n, T)
    return p if precision == "f32" else _round(p, torch.float8_e4m3fn)


class _Attention(torch.autograd.Function):
    """Causal grouped-query attention over ``q`` ``[B, S, H, Dh]``, ``k``
    and ``v`` ``[B, S, KH, Dh]``, in blocks of query rows; the backward
    recomputes each block's probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, precision):
        if precision != "f32":
            q, k, v = (_round(t, torch.float8_e4m3fn) for t in (q, k, v))
        B, S, H, Dh = q.shape
        KH = k.shape[2]
        G = H // KH
        qg = q.permute(0, 2, 1, 3).reshape(B, KH, G, S, Dh)
        kt = k.permute(0, 2, 1, 3).contiguous()
        vt = v.permute(0, 2, 1, 3).contiguous()
        n = max(1, min(S, _BLOCK_ELEMS // (B * H * S)))
        scale = 1.0 / math.sqrt(Dh)
        o = torch.empty_like(qg)
        for r0 in range(0, S, n):
            m = min(n, S - r0)
            qb = qg[:, :, :, r0:r0 + m].reshape(B, KH, G * m, Dh)
            p = _probs(qb, kt[:, :, :r0 + m], r0, m, G, scale, precision)
            o[:, :, :, r0:r0 + m] = (p @ vt[:, :, :r0 + m]).view(B, KH, G, m, Dh)
        ctx.save_for_backward(qg, kt, vt, o)
        ctx.args = (n, scale, precision)
        return o.reshape(B, H, S, Dh).permute(0, 2, 1, 3)

    @staticmethod
    def backward(ctx, do):
        qg, kt, vt, o = ctx.saved_tensors
        n, scale, precision = ctx.args
        B, KH, G, S, Dh = qg.shape
        if precision != "f32":
            do = _round(do, torch.float8_e5m2)
        dog = do.permute(0, 2, 1, 3).reshape(B, KH, G, S, Dh)
        delta = (dog * o).sum(-1)
        dq = torch.empty_like(qg)
        dk = torch.zeros_like(kt)
        dv = torch.zeros_like(vt)
        for r0 in range(0, S, n):
            m = min(n, S - r0)
            T = r0 + m
            qb = qg[:, :, :, r0:T].reshape(B, KH, G * m, Dh)
            dob = dog[:, :, :, r0:T].reshape(B, KH, G * m, Dh)
            p = _probs(qb, kt[:, :, :T], r0, m, G, scale, precision)
            dv[:, :, :T] += p.transpose(-1, -2) @ dob
            dp = dob @ vt[:, :, :T].transpose(-1, -2)
            ds = p * (dp - delta[:, :, :, r0:T].reshape(B, KH, G * m, 1))
            dq[:, :, :, r0:T] = (ds @ kt[:, :, :T]).view(B, KH, G, m, Dh) * scale
            dk[:, :, :T] += (ds.transpose(-1, -2) @ qb) * scale
        H = KH * G
        dq = dq.reshape(B, H, S, Dh).permute(0, 2, 1, 3)
        return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3), None


def _block(x, cos, sin, an, wq, wk, wv, wo, mn, wg, wu, wd, cfg, precision):
    B, S, _ = x.shape
    H, KH, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps = cfg["rms_norm_eps"]
    h = rms_norm(x, an, eps)
    q = rope(_linear(h, wq, precision).view(B, S, H, Dh), cos, sin)
    k = rope(_linear(h, wk, precision).view(B, S, KH, Dh), cos, sin)
    v = _linear(h, wv, precision).view(B, S, KH, Dh)
    a = _Attention.apply(q, k, v, precision)
    x = x + _linear(a.reshape(B, S, H * Dh), wo, precision)
    h = rms_norm(x, mn, eps)
    mlp = _linear(F.silu(_linear(h, wg, precision)) * _linear(h, wu, precision), wd, precision)
    return x + mlp


def _head_xent_sum(h, w, labels, precision):
    logits = _linear(h, w, precision)
    return (torch.logsumexp(logits, -1) - logits.gather(1, labels[:, None])[:, 0]).sum()


def loss(params: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor, precision: str = "f32"):
    """Mean next-token cross-entropy of ``tokens`` ``[B, S]``."""
    B, S = tokens.shape
    cos, sin = rope_tables(S, cfg["head_dim"], cfg["rope_theta"], tokens.device)
    x = F.embedding(tokens, params["embed.weight"])
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        args = [params[p + n] for n in (
            "attn_norm.weight", "attn.q_proj.weight", "attn.k_proj.weight", "attn.v_proj.weight",
            "attn.o_proj.weight", "mlp_norm.weight", "mlp.gate_proj.weight", "mlp.up_proj.weight",
            "mlp.down_proj.weight",
        )]
        x = checkpoint(_block, x, cos, sin, *args, cfg, precision, use_reentrant=False)
    h = rms_norm(x, params["final_norm.weight"], cfg["rms_norm_eps"])[:, :-1].reshape(-1, x.shape[-1])
    labels = tokens[:, 1:].reshape(-1)
    w = params["lm_head.weight"]
    rows = max(1, _BLOCK_ELEMS // w.shape[0])
    total = 0.0
    for r in range(0, h.shape[0], rows):
        total = total + checkpoint(_head_xent_sum, h[r:r + rows], w, labels[r:r + rows], precision,
                                   use_reentrant=False)
    return total / h.shape[0]


@torch.no_grad()
def adamw_(p, g, m, v, t: int, *, lr: float, betas, eps: float, weight_decay: float) -> None:
    """One AdamW update of ``p`` in place (step ``t``, 1-based)."""
    b1, b2 = betas
    p.mul_(1 - lr * weight_decay)
    m.lerp_(g, 1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    denom = (v.sqrt() / math.sqrt(1 - b2**t)).add_(eps)
    p.addcdiv_(m, denom, value=-lr / (1 - b1**t))


def train_readings(cfg: dict, batches: List[torch.Tensor], seed: int, precision: str = "f32") -> Readings:
    """Draw the seed's weights on the batches' device, take one AdamW step
    on each batch, and read the losses, the first gradient's norms and the
    parameters' change (:class:`Readings`)."""
    opt = cfg["assumed"]["optimizer"]
    hyper = dict(lr=opt["lr"], betas=tuple(opt["betas"]), eps=opt["eps"],
                 weight_decay=opt["weight_decay"])
    device = batches[0].device
    with full_f32():
        params = weights.draw(cfg, seed, device)
        for p in params.values():
            p.requires_grad_(True)
        moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in params.items()}
        losses, grad_norms = [], {}
        for t, tokens in enumerate(batches, start=1):
            value = loss(params, cfg, tokens, precision)
            value.backward()
            losses.append(value.item())
            if t == 1:
                grad_norms = {n: torch.linalg.vector_norm(p.grad).item() for n, p in params.items()}
            for n, p in params.items():
                adamw_(p, p.grad, *moments[n], t, **hyper)
                p.grad = None
        del moments
        change = {n: v.item() for n, v in weights.change_norms(params, cfg, seed).items()}
    return Readings(losses, grad_norms, change)
