"""File-backed token data — the port of ``pytorch_operator_tpu/data/``'s
record format (:mod:`array_file`), the C++ prefetching loader and its Python
fallback (:mod:`native_loader`), the text packer (:mod:`pack`), and the
device feed that runs ahead of the step loop (:mod:`device_prefetch`, with
its depth controller :mod:`feed_autotune`), and
:func:`open_training_loader`, the loader every training workload opens.
"""

from .array_file import ArrayFileMeta, field_max, field_range, pack_arrays, read_meta
from .native_loader import (
    LoaderDataError,
    LoaderUnavailable,
    NativeLoader,
    PyLoader,
    open_loader,
)


def open_training_loader(path, batch: int, *, seed: int = 0, processes: int = 1):
    """``open_loader`` with the gang-determinism guard of every training
    workload: a world of more than one process pins the native loader,
    because the Python fallback shuffles with another generator and the
    ranks would take their rows from different permutations."""
    return open_loader(path, batch, seed=seed, native=True if processes > 1 else None)


__all__ = [
    "ArrayFileMeta",
    "field_max",
    "field_range",
    "pack_arrays",
    "read_meta",
    "LoaderDataError",
    "LoaderUnavailable",
    "NativeLoader",
    "PyLoader",
    "open_loader",
    "open_training_loader",
]
