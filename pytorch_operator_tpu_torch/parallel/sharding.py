"""Laying a model out on a mesh — the port of
``pytorch_operator_tpu/parallel/sharding.py``.

The logical-axis rule table is the JAX package's (:data:`DEFAULT_RULES`,
:func:`filter_axis_for_mesh`, :func:`logical_to_mesh_axes`): it says which
mesh axes the batch and each parameter axis map to. JAX lets XLA insert the
collectives a sharding implies; here the two kinds of axes are laid out
apart.

**tp.** :data:`LLAMA_PARAM_AXES` names each Llama parameter's logical axes
(the JAX model's annotations turned to ``nn.Linear``'s ``[out, in]``), and
:func:`tp_dim` reads from the rule table the dim that ``tp`` splits: the
heads of q/k/v (dim 0) and o (dim 1), the MLP's ``d_ff`` (gate and up dim
0, down dim 1), the vocabulary of the embedding and the head (dim 0); the
norms are replicated. A tensor-parallel model (``Llama(cfg,
tp=TensorParallel...)``) holds only its rank's block of each such tensor, a
plain tensor, and runs its collectives itself
(``collectives.tp_enter``/``tp_leave``): PyTorch's ``parallelize_module``
redistributes through DTensor's functional collectives, which crash under
gloo on CUDA tensors.

**dp, fsdp** (the rule for ``"batch"``) are laid out with FSDP2:
:func:`shard_model` calls ``torch.distributed.fsdp.fully_shard`` on each
decoder block and then on the root, over the mesh of the data axes (one
such mesh a tp coordinate). ``fsdp`` is the shard dimension: every parameter (a
tp block, under tp), its gradient and its optimizer state become DTensors
sharded on dim 0, gathered per block for the forward and the backward and
reduce-scattered after it. ``dp`` replicates: on a mesh ``(dp, fsdp)``
FSDP2 is HSDP (an all-reduce over ``dp`` after the reduce-scatter over
``fsdp``), and a mesh with ``dp`` alone is HSDP with a one-rank shard
dimension (the gradients all-reduced, the parameters whole on every rank).

:class:`Block` says where a rank's part of a tensor sits in the whole
(tp's block, FSDP2's rows of it): the checkpoint writes and restores by it,
:func:`full_tensor` gathers by the same rule.

The master weights stay in their dtype (f32) and are cast at the call as on
one device; no mixed-precision policy is set, so gradients reduce in f32,
as JAX's psum does. Known, deliberate differences: JAX's ``fsdp_spec``
shards a parameter's largest evenly divisible dimension of at least 2^16
elements; FSDP2 shards dim 0 of every parameter (of its tp block). And JAX
splits the ``[in, out]`` kernels; the port splits the same logical axis of
the ``[out, in]`` weight. The bytes a rank holds differ, the numerics do
not.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...], None]
LogicalRules = Sequence[Tuple[str, MeshAxes]]

# The JAX package's rule table: earlier entries win; None replicates; a
# tuple shards over those mesh axes jointly (the batch over dp AND fsdp).
DEFAULT_RULES: LogicalRules = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("vocab", "tp"),
    ("expert", "ep"),
    ("stage", "pp"),
    ("head_dim", None),
    ("norm", None),
    ("layers", None),
)


def filter_axis_for_mesh(mesh_ax: MeshAxes, mesh_axes: Optional[set]) -> MeshAxes:
    """Drop mesh axes absent from ``mesh_axes`` (None keeps everything);
    tuples are filtered member-wise and collapse to a bare string (one
    member) or None (empty)."""
    if mesh_ax is None or mesh_axes is None:
        return mesh_ax
    if isinstance(mesh_ax, tuple):
        kept = tuple(a for a in mesh_ax if a in mesh_axes)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept
    return mesh_ax if mesh_ax in mesh_axes else None


def logical_to_mesh_axes(
    logical_axes: Sequence[Optional[str]], rules: LogicalRules = DEFAULT_RULES, mesh_axes=None,
) -> list:
    """The mesh axes of each logical axis (``logical_to_spec``'s entries,
    trailing Nones trimmed), for a mesh with axes ``mesh_axes``."""
    table = {}
    for name, mesh_ax in rules:
        table.setdefault(name, mesh_ax)
    names = set(mesh_axes) if mesh_axes is not None else None
    out = [
        filter_axis_for_mesh(table.get(ax), names) if ax is not None else None
        for ax in logical_axes
    ]
    while out and out[-1] is None:
        out.pop()
    return out


def data_axes(mesh_axes, rules: LogicalRules = DEFAULT_RULES) -> tuple:
    """The mesh axes the batch is split over (the ``"batch"`` rule), in the
    mesh's order."""
    ax = logical_to_mesh_axes(("batch",), rules, mesh_axes)
    ax = ax[0] if ax else None
    kept = () if ax is None else ((ax,) if isinstance(ax, str) else ax)
    return tuple(a for a in mesh_axes if a in kept)


# Each Llama parameter's logical axes in the port's orientation (a weight
# [out, in]), by the end of its state-dict name: the JAX model's
# annotations (models/llama.py: q l.325, k/v l.330, o l.406, gate/up l.578,
# down l.587, embed l.763, head l.803).
LLAMA_PARAM_AXES = (
    ("attn.q_proj.weight", ("heads", "embed")),
    ("attn.k_proj.weight", ("kv_heads", "embed")),
    ("attn.v_proj.weight", ("kv_heads", "embed")),
    ("attn.o_proj.weight", ("embed", "heads")),
    ("mlp.gate_proj.weight", ("mlp", "embed")),
    ("mlp.up_proj.weight", ("mlp", "embed")),
    ("mlp.down_proj.weight", ("embed", "mlp")),
    ("embed.weight", ("vocab", "embed")),
    ("lm_head.weight", ("vocab", "embed")),
    ("norm.weight", ("norm",)),
)


def param_axes(name: str) -> tuple:
    """The logical axes of the Llama parameter ``name``."""
    for suffix, axes in LLAMA_PARAM_AXES:
        if name.endswith(suffix):
            return axes
    raise KeyError(f"no logical axes for parameter {name!r} (tensor parallelism lays out the dense Llama)")


def tp_dim(name: str, rules: LogicalRules = DEFAULT_RULES) -> Optional[int]:
    """The dim of parameter ``name`` that ``tp`` splits under ``rules``, or
    None (replicated)."""
    axes = logical_to_mesh_axes(param_axes(name), rules, {"tp"})
    dims = [i for i, ax in enumerate(axes) if ax == "tp"]
    return dims[0] if dims else None


@dataclass(frozen=True)
class TensorParallel:
    """The ``tp`` axis as a model holds it: ``size`` ranks, this one at
    ``index``; ``mesh`` the ``DeviceMesh`` whose ``tp`` group the
    collectives run on."""

    size: int
    index: int
    mesh: Any = None

    @classmethod
    def of(cls, mesh) -> Optional["TensorParallel"]:
        """The mesh's tp axis, or None when it has none (or of size 1)."""
        from .mesh import train_coords

        c = train_coords(mesh)
        return cls(c.tp_size, c.tp_index, mesh) if c.tp_size > 1 else None

    def enter(self, x):
        from .collectives import tp_enter

        return tp_enter(x, "tp", self.mesh)

    def leave(self, x):
        from .collectives import tp_leave

        return tp_leave(x, "tp", self.mesh)

    def block(self, n: int, what: str) -> tuple:
        """``(start, length)`` of this rank's block of ``n`` (``what``: its
        name in the error); tp must divide ``n``."""
        if n % self.size:
            raise ValueError(f"tp={self.size} does not divide {what}={n}")
        k = n // self.size
        return self.index * k, k


def check_tp_divides(cfg, size: int) -> None:
    """Refuse a tp that does not divide a dimension it splits, naming it.
    (JAX runs such a mesh, XLA replicating what does not divide: ROADMAP.md
    Queue 1 lists the port's counterpart as still to do.)"""
    if size <= 1:
        return
    for what in ("n_heads", "n_kv_heads", "d_ff", "vocab_size"):
        n = getattr(cfg, what)
        if n % size:
            raise NotImplementedError(
                f"tp={size} does not divide {what}={n}: this port splits only dimensions tp "
                "divides (replicating the rest, as XLA does, is still to do: ROADMAP.md Queue 1)"
            )


def dim0_rows(shape, mesh, placements) -> tuple:
    """``(offset, rows)``: the rows of dim 0 this rank holds of a DTensor of
    global ``shape`` laid out as ``placements`` on ``mesh``: FSDP2's
    ``Shard(0)`` takes ``torch.chunk``'s blocks (ceil-sized, the last ones
    short or empty), a ``Replicate`` dimension takes them all."""
    offset, rows = 0, int(shape[0])
    for i, pl in enumerate(placements):
        if pl.is_shard():
            if pl.dim != 0:
                raise NotImplementedError(f"a Shard({pl.dim}) layout (FSDP2 shards dim 0)")
            chunk = -(-rows // mesh.size(i))
            start = min(mesh.get_local_rank(i) * chunk, rows)
            offset, rows = offset + start, min(start + chunk, rows) - start
    return offset, rows


@dataclass
class Block:
    """This rank's part of a tensor and where it sits in the whole:
    ``local`` (a tensor, or the DTensor of FSDP2 that holds it), the whole
    tensor's ``shape``, the part's ``offsets`` on every dim, and whether
    this rank is the one that writes it (``writer``: the lowest coordinate
    of every mesh axis that holds the same part)."""

    local: Any
    offsets: tuple
    shape: tuple
    writer: bool = True

    @property
    def data(self):
        """The part itself, a plain tensor."""
        return local_tensor(self.local)

    @classmethod
    def of(cls, t, dim: Optional[int] = None, tp: Optional[TensorParallel] = None) -> "Block":
        """The block of ``t`` (a tensor, or a DTensor of FSDP2's dim-0
        layout) when ``tp`` splits its dim ``dim`` (None: replicated over
        tp, written by tp's coordinate 0)."""
        from torch.distributed.tensor import DTensor

        shape = list(t.shape)
        offsets = [0] * len(shape)
        writer = True
        if isinstance(t, DTensor):
            offsets[0], _ = dim0_rows(t.shape, t.device_mesh, t.placements)
            writer = all(t.device_mesh.get_local_rank(i) == 0
                         for i, pl in enumerate(t.placements) if pl.is_replicate())
        if tp is not None and tp.size > 1:
            if dim is None:
                writer = writer and tp.index == 0
            else:
                offsets[dim] += tp.index * shape[dim]
                shape[dim] *= tp.size
        return cls(t, tuple(offsets), tuple(shape), writer)


def model_blocks(model) -> dict:
    """A model's state dict as :class:`Block` s (name: its block), the
    layout a checkpoint writes: each tp parameter's block of the whole,
    FSDP2's rows of it."""
    tp = getattr(model, "tp", None)
    return {name: Block.of(t, tp_dim(name) if tp is not None else None, tp)
            for name, t in model.state_dict().items()}


def shard_model(model, mesh):
    """Lay ``model`` out on ``mesh``: tp first (the model must hold the
    mesh's tp blocks already: built with ``tp=TensorParallel.of(mesh)``),
    then FSDP2 over the data axes, each decoder block of ``model.layers``
    and then the root (embedding, final norm, LM head), one data mesh a tp
    coordinate. Returns the model, whose parameters are then DTensors (none
    on a mesh whose data axes hold one rank). Every rank of a tp coordinate
    must hold the same values before the call (the same seeded init or the
    same ``init_params``): each keeps its own shard of them."""
    from torch.distributed.fsdp import fully_shard

    from .mesh import axis_sizes

    sizes = axis_sizes(mesh)
    tp = getattr(model, "tp", None)
    if sizes.get("tp", 1) != (tp.size if tp is not None else 1):
        raise ValueError(
            f"the mesh has tp={sizes.get('tp', 1)} but the model holds "
            f"{'whole tensors' if tp is None else f'tp={tp.size} blocks'}: build it with "
            "tp=TensorParallel.of(mesh)"
        )
    axes = data_axes(mesh.mesh_dim_names)
    if math.prod(sizes[a] for a in axes) == 1:
        return model
    if "fsdp" in axes:
        data_mesh = mesh[axes] if len(axes) > 1 else mesh["fsdp"]
    else:
        # dp alone: HSDP with a one-rank shard dimension. DeviceMesh slices
        # only what exists, so the same ranks are laid out again with an
        # fsdp axis of one after dp (a tp axis keeps its groups).
        from torch.distributed.device_mesh import DeviceMesh

        names = list(mesh.mesh_dim_names)
        at = names.index("dp") + 1
        full = DeviceMesh(mesh.device_type, mesh.mesh.unsqueeze(at),
                          mesh_dim_names=tuple(names[:at] + ["fsdp"] + names[at:]))
        data_mesh = full[("dp", "fsdp")]
    # FSDP2 wants one parameter dtype a unit: with bf16 parameters the f32
    # norm scales are units of their own (each is called as a module, so
    # its unit gathers it), leaving the matmul weights in the blocks and
    # the embedding and head in the root.
    mixed = len({p.dtype for p in model.parameters()}) > 1
    for block in model.layers:
        if mixed:
            for norm in (block.attn_norm, block.mlp_norm):
                fully_shard(norm, mesh=data_mesh)
        fully_shard(block, mesh=data_mesh)
    if mixed:
        fully_shard(model.final_norm, mesh=data_mesh)
    fully_shard(model, mesh=data_mesh)
    return model


def full_tensor(t, dim: Optional[int] = None, tp: Optional[TensorParallel] = None):
    """The whole of ``t`` on every rank: a DTensor sharded on dim 0 over at
    most one mesh dimension (FSDP2's and HSDP's layouts) gathered with the
    c10d all-gather (each rank's rows padded to the ceil-sized chunk, the
    padding cut off after); then, when ``tp`` splits its dim ``dim``, the tp
    blocks gathered along it. ``t`` itself if it is neither.
    ``DTensor.full_tensor`` would gather through functional collectives,
    which crash over gloo on CUDA tensors (torch 2.11)."""
    if dim is not None and tp is not None and tp.size > 1:
        from .collectives import all_gather

        block = full_tensor(t).movedim(dim, 0).contiguous()
        return all_gather(block, "tp", tp.mesh).movedim(0, dim)
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    local = t.to_local()
    shards = [(i, pl) for i, pl in enumerate(t.placements) if pl.is_shard()]
    if not shards:
        return local
    if len(shards) > 1 or shards[0][1].dim != 0:
        raise NotImplementedError(f"gathering a {t.placements} layout (only one Shard(0))")
    import torch
    import torch.distributed as dist

    group = t.device_mesh.get_group(shards[0][0])
    n, rows = dist.get_world_size(group), t.shape[0]
    chunk = -(-rows // n)
    padded = torch.zeros((chunk, *local.shape[1:]), dtype=local.dtype, device=local.device)
    padded[: local.shape[0]] = local
    out = torch.empty((n * chunk, *local.shape[1:]), dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(out, padded, group=group)
    return out[:rows]


def full_state_dict(model) -> dict:
    """The whole of each tensor of ``model.state_dict()`` on every rank (CPU
    tensors, in state-dict order), gathered from FSDP2's shards and tp's
    blocks."""
    tp = getattr(model, "tp", None)
    return {
        name: full_tensor(t, tp_dim(name) if tp is not None else None, tp).detach().cpu()
        for name, t in model.state_dict().items()
    }


def local_tensor(t):
    """This rank's part of ``t``: a DTensor's local shard, else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def local_nbytes(tensors) -> int:
    """Bytes this rank holds of ``tensors`` (DTensors count their local
    shard, a tp block its own bytes)."""
    return sum(local_tensor(t).nbytes for t in tensors)
