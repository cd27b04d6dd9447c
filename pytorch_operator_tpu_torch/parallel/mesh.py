"""Device meshes — the port of ``pytorch_operator_tpu/parallel/mesh.py``.

The spec grammar is the JAX package's, copied with its errors: a mapping or
a string ``"fsdp=4,tp=2"`` with at most one ``-1`` wildcard, axes from
:data:`MESH_AXIS_ORDER`, and the ``@dcn`` suffix marking inter-slice axes
(``"dp=2@dcn,fsdp=-1"``). A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the world,
one device a process, its dimensions named in ``MESH_AXIS_ORDER`` (``@dcn``
axes outermost), so that the process group of one axis is
``mesh.get_group(axis)``. Building one needs a joined multi-process world
(``runtime.rendezvous.initialize_from_env``).

Canonical axis names: ``dp`` (replicated parameters, sharded batch),
``fsdp`` (parameters and optimizer state sharded too), ``tp`` (each
parameter split by the rule table's tensor-parallel axes, the batch
replicated), ``sp``, ``pp``, ``ep``. This package trains on ``dp``,
``fsdp`` and ``tp``; the other three parse and resolve, and ``llama_train``
refuses them (ROADMAP.md items 3c-2 and 3c-3). :func:`train_coords` gives
a rank its place on the data axes and on ``tp``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Mapping, Union

MESH_AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")
# tp innermost: its collectives are the most latency-sensitive.


def split_hybrid_spec(spec: str) -> tuple[str, str]:
    """Split a string spec into ``(ici, dcn)`` halves: axes marked with the
    ``@dcn`` suffix go to the dcn half."""
    ici_parts, dcn_parts = [], []
    for part in spec.split(","):
        part = part.strip()
        if part.endswith("@dcn"):
            dcn_parts.append(part[: -len("@dcn")])
        elif part:
            ici_parts.append(part)
    return ",".join(ici_parts), ",".join(dcn_parts)


def parse_mesh_spec(spec: Union[str, Mapping[str, int]]) -> Dict[str, int]:
    """Parse ``"dp=2,tp=4"`` (or a mapping) into an ordered axis dict;
    ``@dcn`` suffixes are accepted and stripped."""
    if isinstance(spec, str):
        out: Dict[str, int] = {}
        for part in spec.split(","):
            part = part.strip()
            if part.endswith("@dcn"):
                part = part[: -len("@dcn")]
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"mesh spec {spec!r}: expected axis=size, got {part!r}")
            name, _, size = part.partition("=")
            out[name.strip()] = int(size)
    else:
        out = dict(spec)
    for name, size in out.items():
        if name not in MESH_AXIS_ORDER:
            raise ValueError(
                f"unknown mesh axis {name!r} (valid: {', '.join(MESH_AXIS_ORDER)})"
            )
        if size != -1 and size < 1:
            raise ValueError(f"mesh axis {name}: size must be >= 1 or -1, got {size}")
    if sum(1 for s in out.values() if s == -1) > 1:
        raise ValueError("mesh spec may contain at most one -1 wildcard")
    return out


def resolve_axis_sizes(spec: Union[str, Mapping[str, int]], n_devices: int) -> Dict[str, int]:
    """Resolve a mesh spec against a device count (fills the -1 wildcard,
    checks the product equals the device count), in canonical order."""
    axes = parse_mesh_spec(spec)
    if not axes:
        axes = {"dp": -1}
    known = 1
    wildcard = None
    for name, size in axes.items():
        if size == -1:
            wildcard = name
        else:
            known *= size
    if wildcard is not None:
        if n_devices % known != 0:
            raise ValueError(
                f"mesh spec {axes}: known axis product {known} does not divide "
                f"device count {n_devices}"
            )
        axes[wildcard] = n_devices // known
        known *= axes[wildcard]
    if known != n_devices:
        raise ValueError(f"mesh spec {axes}: axis product {known} != device count {n_devices}")
    return {k: axes[k] for k in MESH_AXIS_ORDER if k in axes}


def hybrid_axis_sizes(spec: Union[str, Mapping[str, int], None], n_devices: int) -> Dict[str, int]:
    """The mesh's axes and sizes in layout order: a plain spec resolved in
    canonical order, a hybrid one (``@dcn`` axes, explicit sizes) with its
    dcn axes outermost and its ici axes resolved against the devices a
    slice (``n_devices`` over the product of the dcn sizes), with the JAX
    package's errors."""
    if spec is None:
        spec = {"dp": -1}
    if not (isinstance(spec, str) and "@dcn" in spec):
        return resolve_axis_sizes(spec, n_devices)
    ici, dcn = split_hybrid_spec(spec)
    dcn_axes = parse_mesh_spec(dcn)
    if any(s == -1 for s in dcn_axes.values()):
        raise ValueError("dcn axes must have explicit sizes (no -1 wildcard)")
    n_slices = 1
    for s in dcn_axes.values():
        n_slices *= s
    if n_devices % n_slices:
        raise ValueError(f"{n_devices} devices do not split into {n_slices} slices")
    per_slice = n_devices // n_slices
    if not parse_mesh_spec(ici):
        if per_slice != 1:
            raise ValueError(
                f"empty ici spec needs exactly 1 device per slice, got {per_slice}"
            )
        ici_axes: Dict[str, int] = {}
    else:
        ici_axes = resolve_axis_sizes(ici, per_slice)
    if set(ici_axes) & set(dcn_axes):
        raise ValueError(
            f"axes {sorted(set(ici_axes) & set(dcn_axes))} appear in both ici and dcn specs"
        )
    return {**dcn_axes, **ici_axes}


def make_mesh(spec: Union[str, Mapping[str, int], None] = None, device_type: str = "cuda"):
    """A ``DeviceMesh`` over every rank of the joined world from a spec
    (default: all ranks on ``dp``); ``@dcn`` specs build the
    :func:`make_hybrid_mesh` layout. Raises when no process group exists."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a joined world (runtime.rendezvous.initialize_from_env)"
        )
    axes = hybrid_axis_sizes(spec, dist.get_world_size())
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(
        device_type, tuple(axes.values()), mesh_dim_names=tuple(axes.keys())
    )


def make_hybrid_mesh(
    ici: Union[str, Mapping[str, int]],
    dcn: Union[str, Mapping[str, int]],
    device_type: str = "cuda",
):
    """A mesh whose ``dcn`` axes are outermost (consecutive ranks share a
    slice, so the ici axes stay within one), as the JAX package lays out
    ``make_hybrid_mesh``: e.g. ``ici="fsdp=-1", dcn="dp=2"``."""
    dcn_axes = parse_mesh_spec(dcn)
    if isinstance(ici, Mapping):
        ici = ",".join(f"{k}={v}" for k, v in ici.items())
    if not dcn_axes:
        return make_mesh(ici, device_type)
    spec = ",".join([f"{k}={v}@dcn" for k, v in dcn_axes.items()] + ([ici] if ici else []))
    return make_mesh(spec, device_type)


# The training workloads' mesh when neither the caller nor the job names one.
DEFAULT_MESH = "fsdp=-1"


def mesh_spec_from_env(default: str = DEFAULT_MESH) -> str:
    """``TPUJOB_MESH`` (supervisor-injected or user-set), else ``default``."""
    return os.environ.get("TPUJOB_MESH", default)


def mesh_from_env(default: str = DEFAULT_MESH, device_type: str = "cuda"):
    """The mesh of :func:`mesh_spec_from_env`."""
    return make_mesh(mesh_spec_from_env(default), device_type)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mapping of sizes."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# The axes that split the batch (the rule table's "batch" rule); every
# other axis sees the same rows.
DATA_AXES = ("dp", "fsdp")


@dataclass(frozen=True)
class TrainCoords:
    """A rank's place in a training mesh: ``data_index`` of ``data_extent``
    over the data axes (row-major over ``dp`` then ``fsdp``: which rows of
    the global batch it trains on) and ``tp_index`` of ``tp_size`` (which
    block of each tensor-parallel parameter it holds). The ranks of one tp
    group share their data coordinate."""

    data_index: int = 0
    data_extent: int = 1
    tp_index: int = 0
    tp_size: int = 1


def train_coords(mesh=None) -> TrainCoords:
    """This rank's :class:`TrainCoords` on ``mesh`` (a ``DeviceMesh``); a
    world of one process (``mesh=None``) is ``(0, 1, 0, 1)``."""
    if mesh is None:
        return TrainCoords()
    sizes = axis_sizes(mesh)
    index, extent = 0, 1
    for axis in DATA_AXES:
        if axis in sizes:
            index = index * sizes[axis] + mesh.get_local_rank(axis)
            extent *= sizes[axis]
    tp = sizes.get("tp", 1)
    return TrainCoords(index, extent, mesh.get_local_rank("tp") if tp > 1 else 0, tp)
