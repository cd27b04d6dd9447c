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

**Token groups over ranks** (:func:`moe_mlp_sparse` with ``tokens=``, a
:class:`TokenSplit`): the reference groups the global ``[B·S]`` tokens of
the step (or of the microbatch) in row-major order, and fills each group's
slots choice-major over the whole group, so whether a token is dropped
depends on tokens that other ranks hold. Each rank routes its own tokens;
only their top-k expert indices cross ranks, in one all-gather a token axis
(int8 when the experts fit, no gradient). From them every rank rebuilds the
global order (:func:`global_token_index`: a rank's rows are its data
coordinate's, its positions its sp block's), computes each routing's slot
with the reference's cumsum, and keeps its own tokens' slots. Its dispatch
and combine then run over the groups its tokens touch, the other ranks'
slots empty. The probabilities, and so the gradients, stay with the token's
own rank, as the reference's ``combine`` carries a token's gradient only
through its own row. Where every group that a rank's tokens touch lies
whole on the rank, the rank groups its own tokens as without ``tokens``
(the same values, bit for bit) and nothing is gathered.
"""

from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .collectives import all_gather, axis_index, axis_size, psum, psum_autograd, tp_enter, tp_leave
from .mesh import DATA_AXES


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


def _slot_positions(top_idx, E: int):
    """Each routing's place in its expert's arrival order within its group:
    ``top_idx`` [..., g, K] (groups leading) → [..., g, K], choice 0 of every
    token of the group before choice 1 (GShard's order, the reference's
    loop over k)."""
    counts = torch.zeros(top_idx.shape[:-2] + (1, E), dtype=torch.int64, device=top_idx.device)
    pos = []
    for k in range(top_idx.shape[-1]):
        onehot_k = F.one_hot(top_idx[..., k], E)  # [..., g, E]
        pos_in_e = torch.cumsum(onehot_k, dim=-2) - onehot_k + counts
        pos.append((pos_in_e * onehot_k).sum(-1))  # [..., g]
        counts = counts + onehot_k.sum(dim=-2, keepdim=True)
    return torch.stack(pos, dim=-1)


def _slot_masks(top_idx, pos, probs, E: int, capacity: int):
    """(dispatch, combine) [..., E, C], both f32, of routings ``top_idx``
    [..., K] at slots ``pos`` [..., K] with gates ``probs`` [..., K]: token
    n in slot (e, c) of each routed expert; a slot past ``capacity`` drops
    the routing (its rows are zero)."""
    slots = torch.arange(capacity, device=top_idx.device)
    dispatch = torch.zeros(top_idx.shape[:-1] + (E, capacity), dtype=torch.float32,
                           device=top_idx.device)
    combine = torch.zeros_like(dispatch)
    for k in range(top_idx.shape[-1]):
        onehot_k = F.one_hot(top_idx[..., k], E)
        pos_k = pos[..., k]
        keep = (pos_k < capacity).float()
        # jax.nn.one_hot: an all-zero row for a position past capacity.
        slot = (pos_k.unsqueeze(-1) == slots).float()
        mask = onehot_k.float().unsqueeze(-1) * slot.unsqueeze(-2) * keep[..., None, None]
        dispatch = dispatch + mask
        combine = combine + mask * probs[..., k, None, None]
    return dispatch, combine


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
        return _slot_masks(top_idx, _slot_positions(top_idx, E), probs, E, capacity)


@dataclass(frozen=True)
class TokenSplit:
    """How a rank's tokens lie in the token order that the reference
    groups: the step's (or microbatch's) ``[B, S]`` tokens row-major, of
    which this rank holds ``rows`` rows (its data coordinate's, over the
    data axes among ``axes``) and, with ``"sp"`` among ``axes``, the block of
    ``seq_len/sp`` positions of its sp coordinate; its tokens ``x`` [N, D]
    are row-major over those rows and positions. ``axes``: the axes of
    ``mesh`` that split the tokens (of ``dp``, ``fsdp``, ``sp``); ``mesh``
    None means the world (or the counting mode's axes)."""

    axes: tuple
    rows: int
    seq_len: int
    mesh: object = None


def global_token_index(rows: int, seq_len: int, data_index: int, block=None) -> np.ndarray:
    """The places in the reference's row-major ``[B·S]`` token order of a
    rank's tokens: rows ``data_index·rows`` on of the batch and, with
    ``block=(offset, length)``, positions ``offset`` on of each (all of the
    row without); row-major over the rank's rows and positions, as
    ``x.reshape(-1, D)`` orders them. int64 [rows·length]."""
    off, n = block if block is not None else (0, seq_len)
    r = data_index * rows + np.arange(rows, dtype=np.int64)
    return (r[:, None] * seq_len + off + np.arange(n, dtype=np.int64)).reshape(-1)


def _coords_index(axes, sizes, coords, rows: int, seq_len: int) -> np.ndarray:
    """:func:`global_token_index` of the rank at ``coords`` (a value for
    each of ``axes``): its data index mixed-radix over the data axes among
    ``axes`` in :data:`DATA_AXES` order, its sp block by its sp index."""
    d = 0
    for a in DATA_AXES:
        if a in axes:
            d = d * sizes[a] + coords[a]
    block = None
    if "sp" in axes:
        n = seq_len // sizes["sp"]
        block = (coords["sp"] * n, n)
    return global_token_index(rows, seq_len, d, block)


@dataclass(frozen=True, eq=False)
class _GroupLayout:
    """A rank's share of the global token groups of ``g`` tokens:
    ``order`` the global index of each gathered token (in the gather's
    order, the last of the axes outermost), ``own`` the rank's tokens'
    global indices, ``slot`` each own token's row of the ``[T, width]``
    buffer of the ``T`` groups that its tokens touch (``width`` the most
    own tokens in one of them)."""

    g: int
    T: int
    width: int
    order: np.ndarray
    own: np.ndarray
    slot: np.ndarray


@functools.lru_cache(maxsize=64)
def _group_layout(axes: tuple, sizes: tuple, coords: tuple, rows: int, seq_len: int,
                  group_size: int) -> Optional[_GroupLayout]:
    """The rank's :class:`_GroupLayout`, or None where every group that
    its tokens touch lies whole on it (it then groups its own tokens, as
    the reference's groups)."""
    sizes, coords = dict(zip(axes, sizes)), dict(zip(axes, coords))
    if "sp" in axes and seq_len % sizes["sp"]:
        raise ValueError(f"sp={sizes['sp']} does not divide the sequence of {seq_len}")
    own = _coords_index(axes, sizes, coords, rows, seq_len)
    g = token_group(own.size * math.prod(sizes.values()), group_size)
    group = own // g
    touched, first, counts = np.unique(group, return_index=True, return_counts=True)
    if (counts == g).all():
        return None
    # Gathered over axes[0] first: the stacked dims are axes reversed.
    order = np.concatenate([
        _coords_index(axes, sizes, dict(zip(axes[::-1], c)), rows, seq_len)
        for c in itertools.product(*(range(sizes[a]) for a in axes[::-1]))
    ])
    # A rank's tokens rise in global order, so those of one group are a run.
    t = np.searchsorted(touched, group)
    width = int(counts.max())
    slot = t * width + (np.arange(own.size) - first[t])
    return _GroupLayout(g, touched.size, width, order, own, slot)


@functools.lru_cache(maxsize=64)
def _layout_tensors(lay: _GroupLayout, device: torch.device) -> tuple:
    """(the inverse of ``lay.order``, ``lay.own``, ``lay.slot``) as int64
    tensors on ``device``, made once a layout and device."""
    inv = np.empty_like(lay.order)
    inv[lay.order] = np.arange(lay.order.size)
    return tuple(torch.from_numpy(a).to(device) for a in (inv, lay.own, lay.slot))


def _global_positions(top_idx, E: int, tokens: TokenSplit, lay: _GroupLayout):
    """The slots [N, K] of this rank's routings in the reference's global
    groups: the ranks' expert indices gathered over ``tokens.axes`` (int8
    where E fits, int32 else), put in global order, slotted group by group,
    and this rank's picked out."""
    inv, own, _ = _layout_tensors(lay, top_idx.device)
    routes = top_idx.to(torch.int8 if E <= 127 else torch.int32)
    for a in tokens.axes:
        routes = all_gather(routes, a, tokens.mesh, tiled=False)
    K = top_idx.shape[-1]
    glob = routes.reshape(-1, K).index_select(0, inv).long()
    pos = _slot_positions(glob.view(-1, lay.g, K), E).view(-1, K)
    return pos.index_select(0, own)


def moe_mlp_sparse(
    params,
    x,
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    group_size: int = 1024,
    mesh=None,
    axis: str = "ep",
    tokens: Optional[TokenSplit] = None,
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
    columns of both, runs its experts and the parts are summed over ep.

    ``tokens`` (a :class:`TokenSplit`): ``x`` is this rank's share of the
    tokens of every rank of ``tokens.axes``, and N, the groups and their
    slots are those of all of them (the module docstring)."""
    n_exp, d_model = params["gate"].shape[1], params["w_in"].shape[1]
    if not (1 <= top_k <= n_exp):
        raise ValueError(f"top_k={top_k} outside [1, {n_exp}]")
    e_local, e0, split = _expert_axes(params, mesh, axis)
    N = x.shape[0]
    lay = None
    if tokens is not None and tokens.axes:
        axes = tuple(tokens.axes)
        sizes = tuple(axis_size(a, tokens.mesh) for a in axes)
        coords = tuple(axis_index(a, tokens.mesh) for a in axes)
        lay = _group_layout(axes, sizes, coords, tokens.rows, tokens.seq_len, group_size)
        if lay is not None and lay.own.size != N:
            raise ValueError(f"x holds {N} tokens; {tokens} gives a rank {lay.own.size}")
    if lay is None:
        g = token_group(N, group_size)
        G, C = N // g, math.ceil(g * capacity_factor * top_k / n_exp)
        dispatch, combine = _dispatch_tensors(params, x.reshape(G, g, d_model), top_k, C)
        xg = _enter(x, split, mesh)
    else:
        G, g, C = lay.T, lay.width, math.ceil(lay.g * capacity_factor * top_k / n_exp)
        _, top_idx, probs = _router_topk(params, x, top_k)
        with record_function("moe.slots"):
            pos = _global_positions(top_idx, n_exp, tokens, lay)
            dispatch, combine = _slot_masks(top_idx, pos, probs, n_exp, C)
        # Each own token to its row of the [groups touched, width] buffer;
        # the rows of other ranks' tokens stay zero.
        slot = _layout_tensors(lay, x.device)[2]

        def place(t):
            return t.new_zeros((G * g,) + t.shape[1:]).index_copy(0, slot, t)

        dispatch, combine = place(dispatch), place(combine)
        dispatch, combine = (t.view(G, g, n_exp, C) for t in (dispatch, combine))
        xg = place(_enter(x, split, mesh))
    if split:
        dispatch = dispatch[:, :, e0:e0 + e_local]
        combine = _enter(combine, split, mesh)[:, :, e0:e0 + e_local]
    xg = xg.reshape(G, g, d_model)
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
        out = torch.bmm(combine.to(y.dtype).reshape(G, g, e_local * C), y).reshape(G * g, d_model)
        if lay is not None:
            out = out.index_select(0, _layout_tensors(lay, x.device)[2])
        return _leave(out, split, mesh)


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
