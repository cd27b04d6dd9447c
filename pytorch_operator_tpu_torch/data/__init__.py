"""File-backed token data — the port of ``pytorch_operator_tpu/data/``'s
record format (:mod:`array_file`), the C++ prefetching loader and its Python
fallback (:mod:`native_loader`), the text packer (:mod:`pack`), and the
device feed that runs ahead of the step loop (:mod:`device_prefetch`, with
its depth controller :mod:`feed_autotune`). Not ported yet:
``open_training_loader``, whose one rule pins the native loader across the
processes of a multi-process world (ROADMAP.md: multi-GPU).
"""

from .array_file import ArrayFileMeta, field_max, field_range, pack_arrays, read_meta
from .native_loader import (
    LoaderDataError,
    LoaderUnavailable,
    NativeLoader,
    PyLoader,
    open_loader,
)

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
]
