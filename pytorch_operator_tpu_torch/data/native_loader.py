"""ctypes binding for the C++ prefetching loader (``native/loader.cc``),
with a pure-Python fallback — the port of
``pytorch_operator_tpu/data/native_loader.py``.

Usage::

    with open_loader(path, batch=128, shuffle=True, seed=0) as ld:
        for step in range(steps):
            epoch, index, fields = ld.next_batch()   # dict of np arrays

``next_batch`` returns arrays that are OWNED BY THE LOADER only until the
next ``next_batch``/``close`` for the native path (the slot is released on
the next call): a caller that keeps a batch, or hands it to the card
asynchronously, copies it first (``np.array(..., copy=True)``).

The library is built from the repository's ``native/loader.cc`` (which this
module only reads) with ``g++ -O2 -std=c++17 -fPIC -shared -pthread``, the
flags of ``native/Makefile``, into the gitignored ``build/native/``, under a
file lock, its name carrying a hash of the source and the flags: an edited
source is rebuilt and an unchanged one reused. The first ``NativeLoader``
builds it; nothing happens at import. Without a compiler, :func:`open_loader`
falls back to :class:`PyLoader`, which has the same contract but gathers on
the calling thread and shuffles with numpy's RNG instead of splitmix64 (so
each kind is compared with the JAX package's loader of the same kind).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .array_file import read_meta, split_batch, split_planar

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "loader.cc"
BUILD_DIR = _REPO_ROOT / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread")


class LoaderUnavailable(RuntimeError):
    """The NATIVE loader cannot run here (toolchain/library problem).
    open_loader treats this as 'fall back to PyLoader'."""


class LoaderDataError(ValueError):
    """The data file/parameters are invalid (short file, bad metadata,
    batch > records). NOT caught by open_loader's fallback: both
    implementations raise this up front."""


_lib = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtpujob_loader-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the library unless this source's is already built. Raises
    LoaderUnavailable when it cannot be built here."""
    if not SOURCE.exists():
        raise LoaderUnavailable(f"native source missing: {SOURCE}")
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise LoaderUnavailable("no C++ compiler (g++) to build the native loader")
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Serialise concurrent first-use builds: without the lock one process
    # can load a half-written library while another is linking it.
    with open(BUILD_DIR / ".build.lock", "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if so.exists():  # a peer built it while this one waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise LoaderUnavailable(f"cannot build native loader: {proc.stderr}{proc.stdout}")
        os.replace(tmp, so)
    return so


def _load_lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    lib.tpujob_loader_open.restype = ctypes.c_void_p
    lib.tpujob_loader_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.c_uint64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
    ]
    lib.tpujob_loader_acquire.restype = ctypes.c_void_p
    lib.tpujob_loader_acquire.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.tpujob_loader_release.restype = None
    lib.tpujob_loader_release.argtypes = [ctypes.c_void_p]
    lib.tpujob_loader_batches_per_epoch.restype = ctypes.c_uint64
    lib.tpujob_loader_batches_per_epoch.argtypes = [ctypes.c_void_p]
    lib.tpujob_loader_close.restype = None
    lib.tpujob_loader_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeLoader:
    """Background-prefetching batch loader over a packed array file."""

    kind = "native"

    def __init__(
        self,
        path,
        batch: int,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 4,
    ):
        self.meta = read_meta(path)
        self.batch = batch
        self._handle = None
        lib = _load_lib()
        self._lib = lib
        field_sizes = (ctypes.c_uint64 * len(self.meta.fields))(
            *[f.nbytes for f in self.meta.fields]
        )
        self._handle = lib.tpujob_loader_open(
            str(path).encode(),
            self.meta.record_bytes,
            self.meta.n_records,
            batch,
            prefetch,
            seed,
            1 if shuffle else 0,
            field_sizes,
            len(self.meta.fields),
        )
        if not self._handle:
            # A data/parameter problem, not a toolchain one: open_loader
            # must not swallow it into the PyLoader fallback.
            raise LoaderDataError(
                f"tpujob_loader_open failed for {path} "
                f"(record_bytes={self.meta.record_bytes}, "
                f"n_records={self.meta.n_records}, batch={batch} — is the file "
                f"at least record_bytes*n_records long and batch <= n_records?)"
            )
        self._borrowed = False

    @property
    def batches_per_epoch(self) -> int:
        return int(self._lib.tpujob_loader_batches_per_epoch(self._handle))

    def next_batch(self) -> Tuple[int, int, Dict[str, np.ndarray]]:
        """Blocks for the next prefetched batch; returns (epoch, index,
        {field: array}). Releases the previously borrowed slot first.

        BORROW CONTRACT: the returned arrays are zero-copy views into a
        prefetch ring slot owned by the C++ loader, valid ONLY until the next
        ``next_batch()`` or ``close()``."""
        if self._handle is None:
            raise RuntimeError("loader is closed")
        if self._borrowed:
            self._lib.tpujob_loader_release(self._handle)
            self._borrowed = False
        epoch = ctypes.c_uint64()
        index = ctypes.c_uint64()
        ptr = self._lib.tpujob_loader_acquire(
            self._handle, ctypes.byref(epoch), ctypes.byref(index)
        )
        if not ptr:
            raise RuntimeError("loader closed while waiting for a batch")
        self._borrowed = True
        nbytes = self.batch * self.meta.record_bytes
        raw = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), shape=(nbytes,)
        )
        # The C++ gather wrote the slot planar (field-blocked): the field
        # views are zero-copy.
        return int(epoch.value), int(index.value), split_planar(self.meta, raw, self.batch)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.tpujob_loader_close(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PyLoader:
    """Same contract as NativeLoader, pure numpy (no prefetch thread)."""

    kind = "python"

    def __init__(
        self,
        path,
        batch: int,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.meta = read_meta(path)
        self.batch = batch
        self.shuffle = shuffle
        self.seed = seed
        rb = self.meta.record_bytes
        raw = np.memmap(path, dtype=np.uint8, mode="r")
        need = rb * self.meta.n_records
        if raw.size < need:
            # The native loader's up-front size check.
            raise LoaderDataError(
                f"{path}: {raw.size} bytes < record_bytes*n_records "
                f"({rb}*{self.meta.n_records}={need})"
            )
        if batch < 1 or batch > self.meta.n_records:
            raise LoaderDataError(
                f"{path}: batch {batch} not in [1, n_records={self.meta.n_records}]"
            )
        # Slice before the reshape: trailing bytes are tolerated, as natively.
        self._records = raw[:need].reshape(-1, rb)
        self._epoch = 0
        self._index = 0
        self._perm = self._make_perm()

    def _make_perm(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.meta.n_records)
        # SeedSequence-mixed (seed, epoch), as the JAX package's PyLoader.
        return np.random.default_rng((self.seed, self._epoch)).permutation(
            self.meta.n_records
        )

    @property
    def batches_per_epoch(self) -> int:
        return self.meta.n_records // self.batch

    def next_batch(self) -> Tuple[int, int, Dict[str, np.ndarray]]:
        if self._index >= self.batches_per_epoch:
            self._epoch += 1
            self._index = 0
            self._perm = self._make_perm()
        idx = self._perm[self._index * self.batch : (self._index + 1) * self.batch]
        raw = np.ascontiguousarray(self._records[idx]).reshape(-1)
        out = (self._epoch, self._index, split_batch(self.meta, raw, self.batch))
        self._index += 1
        return out

    def close(self) -> None:
        self._records = None

    def __enter__(self) -> "PyLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_loader(
    path,
    batch: int,
    shuffle: bool = True,
    seed: int = 0,
    native: Optional[bool] = None,
):
    """Open the best available loader. ``native=None`` tries the C++ loader
    and falls back to PyLoader; True/False force one implementation. The
    loader's ``kind`` says which one it is."""
    if native is False:
        return PyLoader(path, batch, shuffle=shuffle, seed=seed)
    try:
        return NativeLoader(path, batch, shuffle=shuffle, seed=seed)
    except LoaderUnavailable:
        if native is True:
            raise
        return PyLoader(path, batch, shuffle=shuffle, seed=seed)
