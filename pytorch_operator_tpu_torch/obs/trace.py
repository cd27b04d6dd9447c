"""Span recording to per-process JSONL ring files — the port's copy of the
writer side of ``pytorch_operator_tpu/obs/trace.py``.

:class:`SpanRecorder` appends one JSON object per span —
``{"name", "cat", "ph": "X", "ts", "dur", "pid", "tid", "args"}`` with
``ts``/``dur`` in microseconds (the Chrome trace event format) — to
``$TPUJOB_TRACE_DIR/<proc>-<pid>.trace.jsonl``, in exactly the JAX package's
record format, so the supervisor's loaders and mergers (``load_span_file``,
``merge_trace_files``, ``tpujob trace --request``), which stay in the JAX
package, read a port replica's spans unchanged. The file is a ring: past
``max_bytes`` it rotates once (``.1`` generation kept, older dropped).

Two ways to record: :func:`span`, a context manager that times the block
it wraps (the training loop's ``step`` and ``save``, the checkpoint
manager's and the async writer's ``ckpt_*`` spans), and :func:`serve_span`,
a span with explicit endpoints (the serve path's hops).

Enablement is the ``TPUJOB_TRACE_DIR`` env knob, read once per process: with
it unset, :func:`tracer` caches None, :func:`span` returns a shared
``nullcontext`` and :func:`serve_span` does nothing — no I/O, no
allocation, one attribute check.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Optional

ENV_VAR = "TPUJOB_TRACE_DIR"

# Ring size per generation; two generations (current + .1) are kept.
# Overridable per process via TPUJOB_TRACE_RING_BYTES.
DEFAULT_MAX_BYTES = 8 << 20
RING_BYTES_ENV = "TPUJOB_TRACE_RING_BYTES"

# Flush cadence: every FLUSH_EVERY records the buffer hits disk so a live
# `tpujob trace` sees near-current spans. Overridable via
# TPUJOB_TRACE_FLUSH_EVERY.
FLUSH_EVERY = 32
FLUSH_EVERY_ENV = "TPUJOB_TRACE_FLUSH_EVERY"

# Category for every serve-path request hop, as in the JAX package.
SERVE_CAT = "serve"


def _env_int(name: str, default: int) -> int:
    """A positive int env override, or the default (malformed or
    non-positive values must never break span recording)."""
    raw = os.environ.get(name, "")
    try:
        v = int(raw)
    except ValueError:
        return default
    return v if v > 0 else default


_NULL = contextlib.nullcontext()

# Process-global recorder, resolved lazily from the env once.
_TRACER: Optional["SpanRecorder"] = None
_RESOLVED = False
_LOCK = threading.Lock()
# Span records this process emitted (under _LOCK).
_RECORDS = 0


def _default_process_name() -> str:
    rtype = os.environ.get("TPUJOB_REPLICA_TYPE")
    if rtype:
        idx = os.environ.get("TPUJOB_REPLICA_INDEX", "0")
        return f"{rtype.lower()}-{idx}"
    return "supervisor"


def tracer() -> Optional["SpanRecorder"]:
    """The process recorder, or None when ``TPUJOB_TRACE_DIR`` is unset
    or empty. Resolved once; :func:`reset_tracer` re-reads (tests)."""
    global _TRACER, _RESOLVED
    if _RESOLVED:
        return _TRACER
    with _LOCK:
        if not _RESOLVED:
            d = os.environ.get(ENV_VAR, "")
            _TRACER = (
                SpanRecorder(
                    d,
                    _default_process_name(),
                    max_bytes=_env_int(RING_BYTES_ENV, DEFAULT_MAX_BYTES),
                    flush_every=_env_int(FLUSH_EVERY_ENV, FLUSH_EVERY),
                )
                if d
                else None
            )
            _RESOLVED = True
    return _TRACER


def trace_enabled() -> bool:
    return tracer() is not None


def records_emitted() -> int:
    """Span records emitted by this process so far (0 when disabled: the
    zero-overhead pin of ``workloads/dataplane_bench.py``)."""
    return _RECORDS


def reset_tracer() -> None:
    """Close and forget the process recorder so the next :func:`tracer`
    call re-reads the env."""
    global _TRACER, _RESOLVED
    with _LOCK:
        if _TRACER is not None:
            _TRACER.close()
        _TRACER, _RESOLVED = None, False


def span(name: str, cat: str = "span", **args):
    """Context manager recording one complete span of the block it wraps.
    Disabled: the shared ``nullcontext`` (no allocation)."""
    rec = tracer()
    if rec is None:
        return _NULL
    return rec.span(name, cat, **args)


def serve_span(name: str, ts: float, dur_s: float, **args) -> None:
    """One serve-path hop span with EXPLICIT endpoints (a queue wait starts
    at the client's submit wall time, a ring transit at the sender's
    stamp). Disabled: one cached-None check, nothing else."""
    rec = tracer()
    if rec is not None:
        rec.emit(name, SERVE_CAT, ts, dur_s, **args)


class SpanRecorder:
    """Appends span records to one per-process JSONL ring file. The JSON
    line is formatted outside the lock; inside it there is an append and a
    size check, with a real ``flush()`` only every ``flush_every`` records
    (plus close). A crash can tear the buffered tail; the JAX package's
    loader skips torn lines."""

    def __init__(
        self,
        trace_dir,
        process_name: Optional[str] = None,
        max_bytes: int = DEFAULT_MAX_BYTES,
        flush_every: int = FLUSH_EVERY,
    ):
        self.trace_dir = Path(trace_dir)
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        self.process_name = process_name or _default_process_name()
        self.pid = os.getpid()
        self.path = self.trace_dir / f"{self.process_name}-{self.pid}.trace.jsonl"
        self.max_bytes = max_bytes
        self.flush_every = max(1, flush_every)
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        self._since_flush = 0
        self._write_header()
        # Normal process exit flushes the buffered tail.
        atexit.register(self.close)

    def _process_meta(self) -> dict:
        return {
            "ph": "M",
            "name": "process_name",
            "pid": self.pid,
            "tid": 0,
            "args": {"name": self.process_name},
        }

    def _write_header(self) -> None:
        # Process name for the merger, plus the clock-sync pair for
        # cross-host alignment.
        meta = [
            self._process_meta(),
            {
                "ph": "M",
                "name": "clock_sync",
                "pid": self.pid,
                "tid": 0,
                "args": {
                    "unix_ts": time.time(),
                    "perf_counter": time.perf_counter(),
                    "job": os.environ.get("TPUJOB_KEY", ""),
                },
            },
        ]
        with self._lock:
            for m in meta:
                self._f.write(json.dumps(m).encode() + b"\n")
            self._f.flush()

    def emit(self, name: str, cat: str, ts: float, dur_s: float, **args) -> None:
        """Record one complete span; ``ts`` is wall-clock seconds of the
        span START, ``dur_s`` its duration."""
        rec = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": round(ts * 1e6, 1),
            "dur": round(dur_s * 1e6, 1),
            "pid": self.pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
        }
        if args:
            rec["args"] = args
        global _RECORDS
        line = json.dumps(rec).encode() + b"\n"
        with _LOCK:
            _RECORDS += 1
        with self._lock:
            if self._f.closed:
                return
            self._maybe_rotate(len(line))
            self._f.write(line)
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._f.flush()
                self._since_flush = 0

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "span", **args):
        """Time the wrapped block (wall-clock start, ``perf_counter``
        duration) and emit it, also when the block raises."""
        t_wall = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.emit(name, cat, t_wall, time.perf_counter() - t0, **args)

    def _maybe_rotate(self, incoming: int) -> None:
        """Ring rotation under the held lock: the current generation moves
        to ``.1`` (replacing the previous one), a fresh file starts."""
        try:
            if self._f.tell() + incoming <= self.max_bytes:
                return
            self._f.flush()
            self._f.close()
            self.path.replace(self.path.with_suffix(".jsonl.1"))
            self._f = open(self.path, "ab")
        except OSError:
            # A full disk must never take the traced process down.
            if self._f.closed:
                self._f = open(os.devnull, "ab")
        # Re-emit the header so the new generation is self-describing.
        self._f.write(json.dumps(self._process_meta()).encode() + b"\n")

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()
