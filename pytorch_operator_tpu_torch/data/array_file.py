"""Packed fixed-record array files (the native loader's on-disk format) —
the port's own copy of ``pytorch_operator_tpu/data/array_file.py``, the same
format byte for byte: a file packed by either package reads the same in both.

One file = N records; one record = the concatenated bytes of one example
across all fields (e.g. image then label). Fixed record size is what lets
the C++ loader mmap + random-gather without any per-record framing, and a
JSON sidecar (``<file>.meta.json``) carries shapes/dtypes so Python can
reconstruct typed arrays from raw slot bytes.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class FieldMeta:
    name: str
    shape: Tuple[int, ...]  # per-record shape (no leading N)
    dtype: str

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(self.dtype).itemsize


@dataclasses.dataclass
class ArrayFileMeta:
    n_records: int
    fields: List[FieldMeta]

    @property
    def record_bytes(self) -> int:
        return sum(f.nbytes for f in self.fields)

    def to_json(self) -> str:
        return json.dumps(
            {
                "n_records": self.n_records,
                "fields": [
                    {"name": f.name, "shape": list(f.shape), "dtype": f.dtype}
                    for f in self.fields
                ],
            }
        )

    @classmethod
    def from_json(cls, text: str) -> "ArrayFileMeta":
        d = json.loads(text)
        return cls(
            n_records=int(d["n_records"]),
            fields=[
                FieldMeta(f["name"], tuple(int(s) for s in f["shape"]), f["dtype"])
                for f in d["fields"]
            ],
        )


def meta_path(path) -> Path:
    return Path(str(path) + ".meta.json")


def field_range(path, meta: ArrayFileMeta, name: str, chunk_records: int = 8192):
    """(min, max) of a field across ALL records — one streaming memmap
    pass at file-read speed. Used to validate token ids up front: a
    per-batch check misses records outside the scanned batches, and BOTH
    out-of-range directions matter (negative ids clamp as silently in
    XLA embedding lookups as too-large ones).
    """
    off = 0
    fm = None
    for f in meta.fields:
        if f.name == name:
            fm = f
            break
        off += f.nbytes
    if fm is None:
        raise KeyError(f"field {name!r} not in {[f.name for f in meta.fields]}")
    R = meta.record_bytes
    data = np.memmap(path, np.uint8, mode="r")
    lo = hi = None
    for i in range(0, meta.n_records, chunk_records):
        j = min(i + chunk_records, meta.n_records)
        block = np.ascontiguousarray(
            data[i * R : j * R].reshape(j - i, R)[:, off : off + fm.nbytes]
        ).reshape(-1).view(fm.dtype)
        bl, bh = block.min(), block.max()
        lo = bl if lo is None else min(lo, bl)
        hi = bh if hi is None else max(hi, bh)
    return lo, hi


def field_max(path, meta: ArrayFileMeta, name: str, chunk_records: int = 8192):
    """Max value of a field (see :func:`field_range`)."""
    return field_range(path, meta, name, chunk_records)[1]


def pack_arrays(path, arrays: Dict[str, np.ndarray]) -> ArrayFileMeta:
    """Write per-example arrays (each shaped ``(N, ...)``) as one record file.

    Field order follows dict insertion order and is part of the format.
    """
    items = list(arrays.items())
    if not items:
        raise ValueError("pack_arrays: no arrays given")
    n = items[0][1].shape[0]
    for name, a in items:
        if a.shape[0] != n:
            raise ValueError(
                f"pack_arrays: field {name!r} has {a.shape[0]} records, expected {n}"
            )
    meta = ArrayFileMeta(
        n_records=n,
        fields=[FieldMeta(name, tuple(a.shape[1:]), str(a.dtype)) for name, a in items],
    )
    path = Path(path)
    with open(path, "wb") as f:
        # Vectorized interleave in record chunks: per-record Python
        # writes cost minutes of interpreter overhead at corpus scale;
        # viewing each field as (N, nbytes) uint8 and concatenating along
        # the byte axis runs at memory bandwidth, chunked to bound the
        # transient buffer.
        CHUNK = 65536
        for i in range(0, n, CHUNK):
            j = min(i + CHUNK, n)
            parts = [
                np.ascontiguousarray(a[i:j]).reshape(j - i, -1).view(np.uint8)
                for _, a in items
            ]
            f.write(np.concatenate(parts, axis=1).tobytes())
    meta_path(path).write_text(meta.to_json())
    return meta


def read_meta(path) -> ArrayFileMeta:
    mp = meta_path(path)
    if not mp.exists():
        raise FileNotFoundError(f"no sidecar {mp} for array file {path}")
    return ArrayFileMeta.from_json(mp.read_text())


def split_batch(
    meta: ArrayFileMeta, raw: np.ndarray, batch: int
) -> Dict[str, np.ndarray]:
    """Split a record-interleaved ``(batch * record_bytes,)`` uint8 buffer
    into typed per-field arrays shaped ``(batch, *field.shape)``. Copies
    per field when records have more than one field (de-interleave)."""
    rb = meta.record_bytes
    recs = raw.reshape(batch, rb)
    out: Dict[str, np.ndarray] = {}
    off = 0
    for f in meta.fields:
        chunk = recs[:, off : off + f.nbytes]
        out[f.name] = np.ascontiguousarray(chunk).view(f.dtype).reshape((batch,) + f.shape)
        off += f.nbytes
    return out


def split_planar(
    meta: ArrayFileMeta, raw: np.ndarray, batch: int
) -> Dict[str, np.ndarray]:
    """Split a planar (field-blocked) slot buffer — the native loader's
    output layout — into typed per-field arrays. Pure zero-copy views, so
    the consumer thread does no byte shuffling at all."""
    out: Dict[str, np.ndarray] = {}
    off = 0
    for f in meta.fields:
        block = raw[off : off + batch * f.nbytes]
        out[f.name] = block.view(f.dtype).reshape((batch,) + f.shape)
        off += batch * f.nbytes
    return out
