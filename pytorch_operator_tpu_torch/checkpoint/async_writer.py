"""Asynchronous checkpoint commits: snapshot and commit as pipelined stages
off the step loop, every step still verified — the port of
``pytorch_operator_tpu/checkpoint/async_writer.py``.

1. **Submit (caller thread)**: write the ``<step>.inflight`` fence, hand the
   payload (or the snapshot callable) to the snapshot stage, return. Only
   ``max_pending`` snapshots are alive at once: a further submit blocks
   until a commit frees a slot (backpressure, not unbounded host memory).
2. **Snapshot stage (one background thread)**: runs a staged submission's
   snapshot callable — in this package, a wait on the CUDA event behind the
   device-to-host copies that :func:`stage_mutable_leaves` issued.
3. **Commit stage (one background thread)**: commits in submission order
   through the caller's ``commit(step, payload, fault)``, which leaves the
   step durable with its checksum sidecar (the sidecar clears the fence).

A crash mid-snapshot or mid-commit leaves a fenced step, which every
restore-side scan skips (``integrity.verify_step`` is False while the fence
exists). A failed snapshot or commit does not stop the step loop: it is
recorded in :attr:`AsyncCheckpointWriter.errors`, passed to ``on_error``
(the manager reports ``checkpoint_save_failed``), its fence is cleared, and
later saves proceed. ``wait()`` and ``close()`` drain both stages.

**The snapshot owns its bytes before ``submit`` returns.** The port's train
step updates the parameters and the optimizer state in place (torch has no
buffer donation), so the JAX package's staged flavour — hold references to
the live arrays, gather them later — would commit a torn state here. Both
flavours copy instead:

- :func:`snapshot_to_host` (eager): a synchronous copy to host memory,
  ``clone()`` for a CPU tensor (``.cpu()`` would return the same storage).
- :func:`stage_mutable_leaves` (staged): ``clone()`` for a CPU tensor; for a
  CUDA tensor, a ``non_blocking`` copy into a pinned host buffer issued on
  the current stream, then one recorded CUDA event. The copy is ordered on
  that stream before the next step's in-place update, so the caller does not
  wait: the snapshot thread waits on the event.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import obs


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def snapshot_to_host(tree: Any) -> Any:
    """A host copy of ``tree`` that owns its bytes, made before returning:
    tensors are copied to the CPU (``clone()`` for a CPU tensor), numpy
    arrays copied, other leaves passed through."""

    def snap(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            return x.clone() if x.device.type == "cpu" else x.to("cpu")
        if isinstance(x, np.ndarray):
            return np.array(x, copy=True)
        return x

    return _map(snap, tree)


def stage_mutable_leaves(tree: Any) -> Callable[[], Any]:
    """The submit-time half of a staged snapshot. CPU tensors and numpy
    arrays are copied now; each CUDA tensor gets a ``non_blocking`` copy into
    a pinned host buffer on its device's current stream, behind which one
    CUDA event per device is recorded. Returns the snapshot: a zero-arg
    callable that waits on those events and returns the host tree. The
    returned tree never holds a live tensor."""
    events = {}

    def stage(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cpu":
                return x.clone()
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x, non_blocking=True)
            events.setdefault(x.device, None)
            return buf
        if isinstance(x, np.ndarray):
            return np.array(x, copy=True)
        return x

    held = _map(stage, tree)
    for dev in events:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events[dev] = ev

    def snapshot():
        for ev in events.values():
            ev.synchronize()
        return held

    return snapshot


class AsyncCheckpointWriter:
    """Commits checkpoint payloads through a two-stage background pipeline
    (snapshot, then commit) strictly in submission order, with
    verified-at-commit semantics.

    ``commit(step, payload, fault)`` runs on the commit thread and leaves the
    step durable with its checksum sidecar. ``fault`` is the injection
    decision made at submit time, on the caller's thread, so a replayed plan
    fires the same saves although the I/O is asynchronous.

    :meth:`submit` enqueues a payload that already owns its bytes;
    :meth:`submit_staged` a zero-arg ``snapshot()`` the snapshot thread runs.
    Both flow through the same queues, so mixed submissions commit in
    submission order. ``root`` enables the inflight fences. ``on_commit(step,
    commit_s, queue_depth, oldest_inflight_age_s, stage_depth)`` runs after
    each commit (the manager reports ``checkpoint_committed``);
    ``on_error(step, exc)`` after each failure.
    """

    def __init__(
        self,
        commit: Callable[[int, Any, Optional[str]], None],
        *,
        root=None,
        max_pending: int = 2,
        on_error: Optional[Callable[[int, BaseException], None]] = None,
        on_commit: Optional[Callable[..., None]] = None,
        clear_fence_on_error: bool = True,
    ):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self._commit = commit
        self._root = root
        # A single-process commit cleans its partial step on failure, so
        # clearing the fence is safe; a multi-process commit
        # (checkpoint/multihost.py) keeps it: shards of peers this process
        # cannot see may exist, and "fenced, not torn" is the invariant.
        self._clear_fence_on_error = clear_fence_on_error
        self._on_error = on_error
        self._on_commit = on_commit
        # step -> submit wall time of submitted, undecided commits (the
        # oldest-inflight-age gauge).
        self._inflight_ts: dict = {}
        self._slots = threading.Semaphore(max_pending)
        # Snapshot stage: (step, payload_or_snapshot, staged, fault,
        # submit perf time). Commit stage: (step, payload, fault).
        self._snap_q: "queue.Queue" = queue.Queue()
        self._q: "queue.Queue" = queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        self._outstanding = 0  # submitted, not yet committed or failed
        self._in_snapshot = 0  # submitted, not yet handed to the commit stage
        self._lock = threading.Lock()
        self._snap_thread: Optional[threading.Thread] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._last_committed: Optional[int] = None
        self.committed: List[int] = []  # commit order
        self.errors: List[Tuple[int, BaseException]] = []

    # ---- submit side (caller thread) ----

    def _enqueue(self, step: int, work, staged: bool, fault) -> None:
        if self._closed:
            raise RuntimeError("writer is closed")
        t0 = time.perf_counter()
        self._slots.acquire()
        waited = time.perf_counter() - t0
        if waited > 1e-4:
            # Backpressure made the step loop wait on the commit queue.
            rec = obs.tracer()
            if rec is not None:
                rec.emit("ckpt_queue_wait", "ckpt", time.time() - waited, waited, step=step)
        if self._root is not None:
            from . import integrity

            integrity.mark_inflight(self._root, step)
        with self._lock:
            # The outstanding count, not queue emptiness, drives the idle
            # barrier: the queues are empty while a thread is mid-snapshot
            # or mid-commit.
            self._outstanding += 1
            self._in_snapshot += 1
            self._inflight_ts[step] = time.time()
            self._idle.clear()
            self._ensure_threads()
        self._snap_q.put((step, work, staged, fault, time.perf_counter()))

    def submit(self, step: int, payload: Any, fault: Optional[str] = None) -> None:
        """Enqueue the commit of a payload that owns its bytes. Blocks only
        while ``max_pending`` snapshots are alive. The fence for ``step`` is
        on disk before this returns."""
        self._enqueue(step, payload, False, fault)

    def submit_staged(
        self, step: int, snapshot: Callable[[], Any], fault: Optional[str] = None
    ) -> None:
        """Enqueue a staged commit: ``snapshot()`` runs on the snapshot
        thread, then its result commits in submission order. Only the fence
        write happens on the caller's thread."""
        self._enqueue(step, snapshot, True, fault)

    def _ensure_threads(self) -> None:
        if self._snap_thread is None or not self._snap_thread.is_alive():
            self._snap_thread = threading.Thread(
                target=self._run_snapshots, name="ckpt-async-snapshot", daemon=True
            )
            self._snap_thread.start()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, name="ckpt-async-commit", daemon=True)
            self._thread.start()

    # ---- both stages (background threads) ----

    def _fail(self, step: int, e: BaseException) -> None:
        """Record, unfence (unless ``clear_fence_on_error`` is off), report:
        the step loop never sees the exception. A failed single-process
        commit has cleaned its partial step, so clearing the fence cannot
        expose a torn one."""
        with self._lock:
            self.errors.append((step, e))
            self._inflight_ts.pop(step, None)
        if self._root is not None and self._clear_fence_on_error:
            from . import integrity

            integrity.clear_inflight(self._root, step)
        if self._on_error is not None:
            try:
                self._on_error(step, e)
            except Exception:
                # invariant: waived — a broken error callback must not mask the failure being recorded
                pass

    def _retire(self) -> None:
        self._slots.release()
        with self._lock:
            self._outstanding -= 1
            if self._outstanding == 0:
                self._idle.set()

    def _run_snapshots(self) -> None:
        while True:
            item = self._snap_q.get()
            if item is None:
                return
            step, work, staged, fault, t_submit = item
            if staged:
                waited = time.perf_counter() - t_submit
                if waited > 1e-4:
                    # The snapshot sat behind an earlier one: the stage-depth
                    # pressure signal, with the save that paid it.
                    rec = obs.tracer()
                    if rec is not None:
                        rec.emit("ckpt_snapshot_wait", "ckpt", time.time() - waited, waited, step=step)
                try:
                    with obs.span("ckpt_snapshot", cat="ckpt", step=step):
                        work = work()
                except BaseException as e:  # noqa: BLE001 — a failed snapshot
                    # must not take the stage down: record it and go on.
                    with self._lock:
                        self._in_snapshot -= 1
                    self._fail(step, e)
                    self._retire()
                    continue
            with self._lock:
                self._in_snapshot -= 1
            self._q.put((step, work, fault))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, payload, fault = item
            del item  # so that dropping ``payload`` frees the snapshot
            try:
                t0 = time.perf_counter()
                with obs.span("ckpt_commit", cat="ckpt", step=step):
                    self._commit(step, payload, fault)
                commit_s = time.perf_counter() - t0
                payload = None  # the snapshot's host memory goes back now
                with self._lock:
                    self._last_committed = step
                    self.committed.append(step)
                    self._inflight_ts.pop(step, None)
                    depth = max(self._outstanding - 1, 0)
                    stage_depth = self._in_snapshot
                    oldest = min(self._inflight_ts.values(), default=None)
                if self._on_commit is not None:
                    try:
                        self._on_commit(
                            step, commit_s, depth, (time.time() - oldest) if oldest else 0.0,
                            stage_depth,
                        )
                    except Exception:
                        # invariant: waived — telemetry must never fail a committed checkpoint
                        pass
            except BaseException as e:  # noqa: BLE001 — a failed commit must
                # never take the commit thread, and every queued save, down.
                self._fail(step, e)
            finally:
                self._retire()

    # ---- barriers ----

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted save has committed or failed. True
        when drained, False on timeout with saves still pending. Does not
        raise on a failed commit: see :attr:`errors`."""
        return self._idle.wait(timeout)

    def last_committed_step(self) -> Optional[int]:
        """Newest step whose commit, sidecar included, finished."""
        with self._lock:
            return self._last_committed

    def pending(self) -> bool:
        return not self._idle.is_set()

    def stats(self) -> dict:
        """Submitted-undecided depth, the oldest in-flight commit's age (0
        when idle) and the snapshot stage's depth."""
        with self._lock:
            oldest = min(self._inflight_ts.values(), default=None)
            return {
                "queue_depth": self._outstanding,
                "oldest_inflight_age_s": time.time() - oldest if oldest else 0.0,
                "snapshot_depth": self._in_snapshot,
            }

    def close(self, timeout: Optional[float] = None) -> bool:
        """Drain, stop both threads, refuse further submits. True when the
        drain completed; False, after a warning, when ``timeout`` expired
        with saves still pending."""
        if self._closed:
            return True
        self._closed = True
        drained = self.wait(timeout)
        if not drained:
            with self._lock:
                left = self._outstanding
            print(
                f"[tpujob] warning: async checkpoint drain timed out after {timeout}s with "
                f"{left} commit(s) still pending — the newest saves may not be durable; "
                "recovery will fall back to the last sidecar-verified step",
                flush=True,
            )
        if self._snap_thread is not None and self._snap_thread.is_alive():
            self._snap_q.put(None)
            self._snap_thread.join(timeout)
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout)
        return drained

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
