"""Top-k mixture-of-experts MLP on one device — the port of
``pytorch_operator_tpu/parallel/moe.py`` without its ``ep`` mesh.

Functions on tensors, with the reference's names and arguments: ``params``
is ``{"gate": [D, E], "w_in": [E, D, F], "w_out": [E, F, D]}`` and ``x`` is
``[N, D]``. The router runs in f32 (the reference's ``astype(f32)``; on the
card a float32 matmul is exact f32 only while TF32 is off, which is
PyTorch's default and which nothing in this package changes); the expert
products run in ``x``'s dtype.

- :func:`moe_mlp_reference`: dense dispatch, every expert over every token,
  each output scaled by its renormalised top-k gate (zero off the top k).
- :func:`moe_mlp_sparse`: GShard's capacity-factor dispatch: tokens in
  groups, each group routed into ``C = ceil(g · cf · top_k / E)`` slots an
  expert by one-hot dispatch and combine products; a token beyond its
  expert's capacity is dropped.
- :func:`load_balance_loss`: the Switch-Transformer auxiliary loss, 1.0 for
  balanced routing, about E for a collapsed router.

The reference writes each product as an ``einsum``; here each is one
``mm`` or ``bmm``, so which of them remat's ``dots`` policy saves
(``models/common.py``: the 2-D GEMMs) does not depend on how a PyTorch
version lowers an einsum. As in JAX's ``dots_with_no_batch_dims_saveable``,
the router's product and the dense path's first expert product
(``nd,edf->enf``, no batch dims) are 2-D and saved; the others have a batch
dim and are recomputed.

Each part runs inside a ``torch.profiler.record_function`` range
(``moe.router``, ``moe.slots``, ``moe.dispatch``, ``moe.experts``), so a
profile can charge the layer's kernels to its parts.

Expert parallelism (the ``mesh=`` argument, :func:`moe_mlp`) needs several
GPUs and raises ``NotImplementedError`` (ROADMAP.md item 3c-2).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

_MESH_ITEM = "ROADMAP.md item 3c-2: expert parallelism over an ep mesh"


def _router_topk(params, x, top_k: int):
    """The one router of both dispatches: f32 logits, the top k, their
    softmax. Returns (logits [..., E], top_idx [..., K], probs [..., K]).

    A stable descending sort breaks ties to the lower expert index, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no order on the card).
    The indices carry no gradient; the probabilities do."""
    with record_function("moe.router"):
        logits = x.float() @ params["gate"].float()
        vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        top_vals, top_idx = vals[..., :top_k], idx[..., :top_k]
        return logits, top_idx, torch.softmax(top_vals, dim=-1)


def _gates(params, x, top_k: int):
    """Per-token dense gate weights [N, E]: the renormalised top-k
    probabilities, zero elsewhere."""
    logits, top_idx, probs = _router_topk(params, x, top_k)
    with record_function("moe.router"):
        return torch.zeros_like(logits).scatter(-1, top_idx, probs)


def load_balance_loss(params, x, top_k: int):
    """Switch-Transformer load-balancing loss ``E · Σ_e f_e · P_e``: ``f_e``
    the share of (token, choice) routings on expert e (no gradient), ``P_e``
    the mean full-softmax router probability of e (the gradient that spreads
    the router)."""
    logits, top_idx, _ = _router_topk(params, x, top_k)
    with record_function("moe.router"):
        E = logits.shape[-1]
        counts = F.one_hot(top_idx, E).float().sum(dim=(0, 1))
        f = (counts / counts.sum()).detach()
        p = torch.softmax(logits, dim=-1).mean(dim=0)
        return E * torch.sum(f * p)


def _expert_ffn(w_in, w_out, gates, x):
    """The gelu FFN of every expert over every token, combined by ``gates``
    [N, E] → [N, D]. GELU is the tanh form, ``jax.nn.gelu``'s default."""
    E, D, Fd = w_in.shape
    N = x.shape[0]
    with record_function("moe.experts"):
        # nd,edf->enf as one 2-D GEMM [N, D] x [D, E·F]: no batch dims.
        h = F.gelu(torch.mm(x, w_in.permute(1, 0, 2).reshape(D, E * Fd)), approximate="tanh")
        y = torch.bmm(h.view(N, E, Fd).transpose(0, 1), w_out)  # enf,efd->end
    with record_function("moe.dispatch"):
        # end,ne->nd, batched over n.
        return torch.bmm(gates.to(y.dtype).unsqueeze(1), y.transpose(0, 1)).squeeze(1)


def moe_mlp_reference(params, x, *, top_k: int = 2):
    """Dense-dispatch MoE on one device: exact top-k routing, compute
    scaling with the expert count."""
    n_exp = params["w_in"].shape[0]
    if not (1 <= top_k <= n_exp):
        raise ValueError(f"top_k={top_k} outside [1, {n_exp}]")
    return _expert_ffn(params["w_in"], params["w_out"], _gates(params, x, top_k), x)


def _dispatch_tensors(params, x, top_k: int, capacity: int):
    """GShard dispatch and combine one-hots of token groups ``x`` [..., g, D]:
    (dispatch [..., g, E, C], combine [..., g, E, C]), both f32. Token n goes
    to slot (e, c) of each routed expert in arrival order, choice 0 of every
    token before choice 1; a token past an expert's capacity C is dropped
    (its rows are zero). The reference computes one group under ``vmap``;
    leading dims here are groups."""
    logits, top_idx, probs = _router_topk(params, x, top_k)
    with record_function("moe.slots"):
        E = logits.shape[-1]
        counts = torch.zeros(logits.shape[:-2] + (1, E), dtype=torch.int64, device=x.device)
        slots = torch.arange(capacity, device=x.device)
        dispatch = torch.zeros(logits.shape + (capacity,), dtype=torch.float32, device=x.device)
        combine = torch.zeros_like(dispatch)
        for k in range(top_k):
            onehot_k = F.one_hot(top_idx[..., k], E)  # [..., g, E]
            # Each token's position in its expert's arrival order.
            pos_in_e = torch.cumsum(onehot_k, dim=-2) - onehot_k + counts
            pos_k = (pos_in_e * onehot_k).sum(-1)  # [..., g]
            counts = counts + onehot_k.sum(dim=-2, keepdim=True)
            keep = (pos_k < capacity).float()
            # jax.nn.one_hot: an all-zero row for a position past capacity.
            slot = (pos_k.unsqueeze(-1) == slots).float()
            mask = onehot_k.float().unsqueeze(-1) * slot.unsqueeze(-2) * keep[..., None, None]
            dispatch = dispatch + mask
            combine = combine + mask * probs[..., k, None, None]
        return dispatch, combine


def moe_mlp_sparse(
    params,
    x,
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    group_size: int = 1024,
    mesh=None,
    axis: str = "ep",
):
    """Capacity-factor sparse MoE dispatch (GShard's one-hot product form).

    Tokens go in groups of ``g``, the largest divisor of N not above
    ``group_size``; each group routes into ``C = ceil(g · capacity_factor ·
    top_k / E)`` slots an expert; the expert FFN runs on the [E, groups·C, D]
    buffer, and the combine product brings the results back, weighted.
    ``dispatch`` is rounded to ``x``'s dtype and ``combine`` to the experts'
    output dtype before their products, as in the reference. ``mesh``
    (expert parallelism) raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(f"moe_mlp_sparse(mesh=...) is not ported yet ({_MESH_ITEM})")
    n_exp, d_model, _ = params["w_in"].shape
    if not (1 <= top_k <= n_exp):
        raise ValueError(f"top_k={top_k} outside [1, {n_exp}]")
    N = x.shape[0]
    # Never reject a token count the dense path accepts.
    g = next(d for d in range(min(group_size, N), 0, -1) if N % d == 0)
    G, C = N // g, math.ceil(g * capacity_factor * top_k / n_exp)
    xg = x.reshape(G, g, d_model)
    dispatch, combine = _dispatch_tensors(params, xg, top_k, C)
    with record_function("moe.dispatch"):
        # gnec,gnd->gecd, then the expert-major layout [E, G·C, D].
        x_e = torch.bmm(dispatch.to(x.dtype).view(G, g, n_exp * C).transpose(1, 2), xg)
        x_e = x_e.view(G, n_exp, C, d_model).transpose(0, 1).reshape(n_exp, G * C, d_model)
    with record_function("moe.experts"):
        h = F.gelu(torch.bmm(x_e, params["w_in"]), approximate="tanh")  # gecd,edf->gecf
        y = torch.bmm(h, params["w_out"])  # gecf,efd->gecd
    with record_function("moe.dispatch"):
        # gnec,gecd->gnd
        y = y.view(n_exp, G, C, d_model).transpose(0, 1).reshape(G, n_exp * C, d_model)
        out = torch.bmm(combine.to(y.dtype).view(G, g, n_exp * C), y)
        return out.reshape(N, d_model)


def moe_mlp(params, x, *, mesh, top_k: int = 2, axis: str = "ep"):
    """The reference's expert-parallel MoE over the ``ep`` mesh axis: not
    ported (several GPUs); one device runs :func:`moe_mlp_reference`."""
    raise NotImplementedError(f"moe_mlp is not ported yet ({_MESH_ITEM})")
