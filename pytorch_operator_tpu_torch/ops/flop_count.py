"""Semantic FLOP and collective counts — the port of
``pytorch_operator_tpu/ops/flop_count.py``.

JAX walks a traced jaxpr; here ``fn`` runs once on meta tensors under a
``TorchDispatchMode`` that sees every aten op, so nothing executes and
counting a 32k-sequence program costs nothing. Same names, same counting
rules (l.16-29 of the reference):

- matmuls (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``; what
  ``linear``, ``matmul`` and ``einsum`` become): 2 x out elements x
  contracted elements, under JAX's name ``dot_general`` (an ``addmm``'s
  bias add counts as an ``add``).
- convolution: 2 x out elements x kernel spatial x C_in/groups, under
  ``conv_general_dilated``; its backward the same for each gradient it
  computes.
- views, copies, casts, pads, gathers, selects, allocations: 0.
- everything else: 1 per output element.
- a hand-written kernel (the flash forward and the two backward kernels) is
  invisible to a dispatch mode (its launch goes through ctypes): its
  wrapper, given meta tensors, launches nothing, runs no plain version and
  records the kernel's rule (``flash_attention.kernel_flops``: JAX's
  ``pallas_call`` rule, the body's FLOPs x the grid, derived from the JAX
  kernel bodies), so one call counts the same whatever implements it. Its
  FLOPs also land in ``FlopCount.by_kernel``.

Remat: a checkpointed forward is recomputed in the backward, and the mode
sees the recomputation (``torch.utils.checkpoint`` reruns the ops).

Collectives are counted at the seams of ``parallel/collectives.py``, per
device, with JAX's primitive names (``psum``, ``pmax``, ``ppermute``,
``all_gather``, ``reduce_scatter``, ``all_to_all``) and payload bytes (the
operand bytes a device sends a call, as ``_comm_bytes``). In counting mode
the seams take the axis sizes and this rank's coordinates from the counter
(``axes``, ``coords``), need no process group, and return an output of the
right shape.

The mesh total: :func:`count_flops` runs ``fn`` once at every coordinate of
``axes`` and sums, so a program whose ranks run the same work counts it
times the ranks, and a pipeline counts the sum of its stages.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

# aten ops that move, route, reshape, cast, allocate or select data: no
# arithmetic (JAX's _ZERO_FLOPS, by their aten names; a slice's and a
# select's backward is JAX's pad).
_ZERO_FLOPS = frozenset(
    {
        "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "expand_as", "view_as",
        "permute", "transpose", "transpose_", "t", "t_", "slice", "select", "squeeze", "squeeze_",
        "unsqueeze", "unsqueeze_", "as_strided", "alias", "detach", "detach_", "split",
        "split_with_sizes", "unbind", "narrow", "chunk", "unfold", "flip", "roll", "repeat",
        "clone", "copy", "copy_", "_to_copy", "contiguous", "lift_fresh", "lift_fresh_copy",
        "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros",
        "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full", "full_like",
        "new_full", "fill", "fill_", "zero_", "scalar_tensor", "arange", "_local_scalar_dense",
        "cat", "stack", "constant_pad_nd", "pad", "index_select", "gather", "index", "embedding",
        "where", "masked_fill", "masked_fill_", "slice_scatter", "select_scatter", "set_",
        "resize_", "_has_compatible_shallow_copy_type", "select_backward", "slice_backward",
    }
)


@dataclass
class FlopCount:
    """Result of :func:`count_flops`: the total, a per-primitive breakdown,
    and the FLOPs of each hand-written kernel's calls (``by_kernel``)."""

    total: float = 0.0
    by_primitive: dict = field(default_factory=dict)
    by_kernel: dict = field(default_factory=dict)

    def _add(self, name: str, flops: float) -> None:
        self.total += flops
        self.by_primitive[name] = self.by_primitive.get(name, 0.0) + flops


@dataclass
class CollectiveCount:
    """Result of :func:`count_collectives`: per-primitive call counts and
    payload bytes (operand bytes per device per call — "bytes sent", not
    link-level wire cost, which depends on the algorithm/topology)."""

    calls: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)

    @property
    def total_calls(self) -> float:
        return sum(self.calls.values())

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())

    def _add(self, name: str, n_bytes: float) -> None:
        self.calls[name] = self.calls.get(name, 0.0) + 1.0
        self.bytes[name] = self.bytes.get(name, 0.0) + n_bytes


class _Counter:
    """What the counting seams read while ``fn`` runs: the axis sizes, this
    rank's coordinates, and where to record FLOPs and collectives."""

    def __init__(self, axes: Dict[str, int], coords: Dict[str, int],
                 flops: Optional[FlopCount] = None, comm: Optional[CollectiveCount] = None):
        self.axes, self.coords, self.flops, self.comm = axes, coords, flops, comm

    def axis_size(self, axis: str) -> int:
        return self.axes.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def collective(self, name: str, *tensors) -> None:
        if self.comm is not None:
            self.comm._add(name, sum(t.numel() * t.element_size() for t in tensors))

    def kernel(self, name: str, flops: Dict[str, float]) -> None:
        if self.flops is not None:
            for prim, n in flops.items():
                self.flops._add(prim, n)
            self.flops.by_kernel[name] = self.flops.by_kernel.get(name, 0.0) + sum(flops.values())


_local = threading.local()


def counter() -> Optional[_Counter]:
    """The counter of the :func:`count_flops` or :func:`count_collectives`
    running on this thread, else None (the seams then run for real)."""
    return getattr(_local, "counter", None)


@contextlib.contextmanager
def _counting(c: _Counter):
    prev = counter()
    _local.counter = c
    try:
        yield c
    finally:
        _local.counter = prev


# aten names of reductions and binary extrema under JAX's primitive names.
_JAX_NAMES = {"sum": "reduce_sum", "amax": "reduce_max", "amin": "reduce_min",
              "maximum": "max", "minimum": "min"}


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def _dims_product(shape, dims) -> int:
    return math.prod(shape[d] for d in dims) or 1


def _aten_flops(name: str, args, kwargs, out) -> Dict[str, float]:
    """FLOPs of one aten op, by primitive name."""
    if name in _ZERO_FLOPS:
        return {}
    if name in ("mm", "bmm", "mv", "dot"):
        return {"dot_general": 2.0 * _numel(out) * args[0].shape[-1]}
    if name in ("addmm", "baddbmm", "addmv"):
        return {"dot_general": 2.0 * _numel(out) * args[1].shape[-1], "add": float(_numel(out))}
    if name == "convolution":
        w = args[1]
        return {"conv_general_dilated": 2.0 * _numel(out) * _dims_product(w.shape, range(1, w.dim()))}
    if name == "convolution_backward":
        # (grad_output, input, weight, ..., groups, output_mask): JAX's two
        # transposed convolutions. dx's output is the input, contracted over
        # the kernel's window and C_out/groups; dw's is the weight,
        # contracted over the batch and the output's positions.
        grad_out, x, w, groups, mask = args[0], args[1], args[2], args[9], args[10]
        window = _dims_product(w.shape, range(2, w.dim()))
        dx = 2.0 * _numel(x) * window * w.shape[0] // groups
        dw = 2.0 * _numel(w) * _numel(grad_out) // w.shape[0]
        return {"conv_general_dilated": dx * bool(mask[0]) + dw * bool(mask[1])}
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return {_JAX_NAMES.get(name, name): float(sum(_numel(o) for o in outs))}


class _FlopMode(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, out: FlopCount):
        super().__init__()
        self.out = out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        result = func(*args, **kwargs)
        for prim, n in _aten_flops(func._overloadpacket.__name__, args, kwargs, result).items():
            if n:
                self.out._add(prim, n)
        return result


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        if x.is_meta:
            return x
        return torch.empty_like(x, device="meta").requires_grad_(x.requires_grad)
    if isinstance(x, dict):
        return {k: _to_meta(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_meta(v) for v in x)
    return x


def count_flops(fn, *args, axes: Optional[Dict[str, int]] = None, **kwargs) -> FlopCount:
    """Total semantic FLOPs of ``fn(*args, **kwargs)`` across the mesh
    ``axes`` (axis name → size; none: one device). Tensor arguments run as
    meta tensors (``fn`` may also close over a model built on
    ``device="meta"``); ``fn`` runs once at every coordinate of ``axes``,
    with the collectives of ``parallel/collectives.py`` in counting mode,
    and the counts are summed."""
    axes = dict(axes or {})
    out = FlopCount()
    meta_args, meta_kwargs = _to_meta(args), _to_meta(kwargs)
    names = list(axes)
    for coord in itertools.product(*(range(axes[a]) for a in names)):
        with _counting(_Counter(axes, dict(zip(names, coord)), flops=out)), _FlopMode(out):
            fn(*meta_args, **meta_kwargs)
    return out


def count_collectives(fn, *args, axes: Optional[Dict[str, int]] = None,
                      coords: Optional[Dict[str, int]] = None, **kwargs) -> CollectiveCount:
    """Per-device collective-communication profile of ``fn(*args,
    **kwargs)`` at this rank's ``coords`` (default 0 on every axis) of the
    mesh ``axes``: how many times each collective runs and the payload bytes
    it moves. Runs on meta tensors with the collectives in counting mode:
    nothing executes and no process group is needed. The companion to
    :func:`count_flops` for comparing communication regimes (ring vs
    ulysses sequence parallelism)."""
    out = CollectiveCount()
    with _counting(_Counter(dict(axes or {}), dict(coords or {}), comm=out)):
        fn(*_to_meta(args), **_to_meta(kwargs))
    return out
