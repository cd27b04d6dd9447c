"""Top-k mixture-of-experts MLP — the port of
``pytorch_operator_tpu/parallel/moe.py``, on one device or with its experts
over the ``ep`` mesh axis.

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

**Expert parallelism** (:func:`moe_mlp`, and :func:`moe_mlp_sparse` with
``mesh=``): ``params["w_in"]``/``["w_out"]`` hold this rank's block of
``E/ep`` experts (``ep_index·E/ep`` on), and on a mesh with ``tp`` each
expert's block of ``F/tp`` (the model's ``tp`` blocks, as the reference's
``moe_mlp`` splits F over tp); the router ``gate`` is whole. The router runs
replicated on every rank, each rank computes its experts' part of the output
with its columns of the gates (dense) or of the dispatch and combine
tensors (sparse), and the parts are summed over ep and tp
(``collectives.tp_leave``: a sum forward, the identity backward). The input
and the gates enter through ``tp_enter`` (the identity forward, a sum
backward): each rank's experts give their part of those gradients. The
router reads the input before it enters, its gradient being whole on every
rank already. A rank's tokens are its own rows (the data axes and sp split
them; ep and tp do not).

:func:`load_balance_loss` with ``token_axes`` takes its routing shares and
mean probabilities over the tokens of every rank of those axes (the
reference computes it on the global batch): the counts are summed, the
probabilities summed with ``psum_autograd``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .collectives import axis_index, axis_size, psum, psum_autograd, tp_enter, tp_leave


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


def load_balance_loss(params, x, top_k: int, *, mesh=None, token_axes=()):
    """Switch-Transformer load-balancing loss ``E · Σ_e f_e · P_e``: ``f_e``
    the share of (token, choice) routings on expert e (no gradient), ``P_e``
    the mean full-softmax router probability of e (the gradient that spreads
    the router). ``token_axes``: the mesh axes that split the tokens; both
    statistics are then over all of them, the same value on every rank."""
    logits, top_idx, _ = _router_topk(params, x, top_k)
    with record_function("moe.router"):
        E = logits.shape[-1]
        counts = F.one_hot(top_idx, E).float().sum(dim=(0, 1))
        axes = [a for a in token_axes if axis_size(a, mesh) > 1]
        if axes:
            p_sum, n = torch.softmax(logits, dim=-1).sum(dim=0), x.shape[0]
            for a in axes:
                counts = psum(counts, a, mesh)
                p_sum = psum_autograd(p_sum, a, mesh)
                n *= axis_size(a, mesh)
            p = p_sum / n
        else:
            p = torch.softmax(logits, dim=-1).mean(dim=0)
        f = (counts / counts.sum()).detach()
        return E * torch.sum(f * p)


def token_group(n: int, limit: int = 1024) -> int:
    """The sparse dispatch's group of ``n`` tokens: the largest divisor of
    ``n`` not above ``limit`` (never rejecting a token count the dense path
    accepts)."""
    return next(d for d in range(min(limit, n), 0, -1) if n % d == 0)


def _expert_axes(params, mesh, axis: str) -> tuple:
    """``(e_local, e0, split_axes)``: the experts this rank holds and the
    first of them, and the mesh axes over which the experts' parts are
    summed (``axis`` and ``tp`` where of size > 1). Raises the reference's
    error when ep does not divide E."""
    n_exp, e_local = params["gate"].shape[1], params["w_in"].shape[0]
    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    ep = axis_size(axis, mesh) if axis in names else 1
    if n_exp % ep:
        raise ValueError(f"experts {n_exp} not divisible by ep={ep}")
    if e_local != n_exp // ep:
        raise ValueError(
            f"w_in holds {e_local} experts; a rank's block of {n_exp} over ep={ep} is {n_exp // ep}"
        )
    split = tuple(a for a in (axis, "tp") if a in names and axis_size(a, mesh) > 1)
    e0 = axis_index(axis, mesh) * e_local if axis in split else 0
    return e_local, e0, split


def _enter(x, axes, mesh):
    for a in axes:
        x = tp_enter(x, a, mesh)
    return x


def _leave(x, axes, mesh):
    for a in axes:
        x = tp_leave(x, a, mesh)
    return x


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
    output dtype before their products, as in the reference. With ``mesh``
    (expert parallelism, the module docstring) the dispatch and combine
    tensors are computed whole on every rank, each rank takes its experts'
    columns of both, runs its experts and the parts are summed over ep."""
    n_exp, d_model = params["gate"].shape[1], params["w_in"].shape[1]
    if not (1 <= top_k <= n_exp):
        raise ValueError(f"top_k={top_k} outside [1, {n_exp}]")
    e_local, e0, split = _expert_axes(params, mesh, axis)
    N = x.shape[0]
    g = token_group(N, group_size)
    G, C = N // g, math.ceil(g * capacity_factor * top_k / n_exp)
    dispatch, combine = _dispatch_tensors(params, x.reshape(G, g, d_model), top_k, C)
    if split:
        dispatch = dispatch[:, :, e0:e0 + e_local]
        combine = _enter(combine, split, mesh)[:, :, e0:e0 + e_local]
    xg = _enter(x, split, mesh).reshape(G, g, d_model)
    with record_function("moe.dispatch"):
        # gnec,gnd->gecd, then the expert-major layout [E, G·C, D].
        x_e = torch.bmm(dispatch.to(x.dtype).reshape(G, g, e_local * C).transpose(1, 2), xg)
        x_e = x_e.view(G, e_local, C, d_model).transpose(0, 1).reshape(e_local, G * C, d_model)
    with record_function("moe.experts"):
        h = F.gelu(torch.bmm(x_e, params["w_in"]), approximate="tanh")  # gecd,edf->gecf
        y = torch.bmm(h, params["w_out"])  # gecf,efd->gecd
    with record_function("moe.dispatch"):
        # gnec,gecd->gnd
        y = y.view(e_local, G, C, d_model).transpose(0, 1).reshape(G, e_local * C, d_model)
        out = torch.bmm(combine.to(y.dtype).reshape(G, g, e_local * C), y)
        return _leave(out.reshape(N, d_model), split, mesh)


def moe_mlp(params, x, *, mesh, top_k: int = 2, axis: str = "ep"):
    """Dense-dispatch MoE with the experts over ``axis`` of ``mesh`` (the
    module docstring): the router whole on every rank, this rank's columns
    ``[ep_index·E/ep, +E/ep)`` of the gates, its experts over its tokens,
    the parts summed over ep (and tp). ``mesh=None``, or a mesh without the
    axis, runs every expert here: :func:`moe_mlp_reference`'s value."""
    n_exp = params["gate"].shape[1]
    if not (1 <= top_k <= n_exp):
        raise ValueError(f"top_k={top_k} outside [1, {n_exp}]")
    e_local, e0, split = _expert_axes(params, mesh, axis)
    gates = _gates(params, x, top_k)
    if split:
        # Entered whole: each rank's gradient fills its own columns.
        gates = _enter(gates, split, mesh)[:, e0:e0 + e_local]
    out = _expert_ffn(params["w_in"], params["w_out"], gates, _enter(x, split, mesh))
    return _leave(out, split, mesh)
