"""Laying a model out on a mesh — the port of
``pytorch_operator_tpu/parallel/sharding.py``.

The logical-axis rule table is the JAX package's (:data:`DEFAULT_RULES`,
:func:`filter_axis_for_mesh`, :func:`logical_to_mesh_axes`): it says which
mesh axes the batch and each parameter axis map to. JAX lets XLA insert the
collectives a sharding implies; here the data axes (``dp``, ``fsdp``: the
rule for ``"batch"``) are laid out with FSDP2: :func:`shard_model` calls
``torch.distributed.fsdp.fully_shard`` on each ``Block`` and then on the
root, over the mesh of the data axes. ``fsdp`` is the shard dimension:
every parameter, its gradient and its optimizer state become DTensors
sharded on dim 0, gathered per block for the forward and the backward and
reduce-scattered after it. ``dp`` replicates: on a mesh ``(dp, fsdp)`` FSDP2
is HSDP (an all-reduce over ``dp`` after the reduce-scatter over ``fsdp``),
and a mesh with ``dp`` alone is HSDP with a one-rank shard dimension (the
gradients all-reduced, the parameters whole on every rank).

The master weights stay in their dtype (f32) and are cast at the call as on
one device; no mixed-precision policy is set, so gradients reduce in f32,
as JAX's psum does. A known, deliberate difference: JAX's ``fsdp_spec``
shards a parameter's largest evenly divisible dimension of at least 2^16
elements; FSDP2 shards dim 0 of every parameter. The bytes a rank holds
differ, the numerics do not.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

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


def shard_model(model, mesh):
    """FSDP2 over ``mesh``'s data axes: each ``Block`` of ``model.layers``,
    then the root (embedding, final norm, LM head). Returns the model, whose
    parameters are now DTensors. Every rank must hold the same values
    before the call (the same seeded init or the same ``init_params``):
    each keeps its own shard of them."""
    from torch.distributed.fsdp import fully_shard

    axes = data_axes(mesh.mesh_dim_names)
    if "fsdp" in axes:
        data_mesh = mesh[axes] if len(axes) > 1 else mesh["fsdp"]
    else:
        # dp alone: HSDP with a one-rank shard dimension. DeviceMesh slices
        # only what exists, so the data mesh is built over (dp, 1).
        from torch.distributed.device_mesh import init_device_mesh

        data_mesh = init_device_mesh(
            mesh.device_type, (mesh["dp"].size(), 1), mesh_dim_names=("dp", "fsdp")
        )
    for block in model.layers:
        fully_shard(block, mesh=data_mesh)
    fully_shard(model, mesh=data_mesh)
    return model


def full_tensor(t):
    """The whole of ``t`` on every rank: a DTensor sharded on dim 0 over at
    most one mesh dimension (FSDP2's and HSDP's layouts) gathered with the
    c10d all-gather (each rank's rows padded to the ceil-sized chunk, the
    padding cut off after); ``t`` itself if it is no DTensor.
    ``DTensor.full_tensor`` would gather through functional collectives,
    which crash over gloo on CUDA tensors (torch 2.11)."""
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


def local_tensor(t):
    """This rank's part of ``t``: a DTensor's local shard, else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def local_nbytes(tensors) -> int:
    """Bytes this rank holds of ``tensors`` (DTensors count their local
    shard)."""
    return sum(local_tensor(t).nbytes for t in tensors)
