"""Pipelined device feed: a producer pool with an autotuned lookahead — the
port of ``pytorch_operator_tpu/data/device_prefetch.py``.

Inline, every step pays its batch's host work and host-to-device copy
between the previous step and its own. :class:`DevicePrefetcher` moves both
onto background threads with a bounded, device-resident lookahead:

- **Serialized produce, concurrent put** (``workers=N``): the ``produce()``
  calls run strictly one at a time in ticket order (loaders hand out
  borrowed slots, and batch order is a determinism contract), while each
  batch's ``put`` (casts, copies, the transfer) runs concurrently across N
  threads; a reorder buffer hands batches to the consumer in exact FIFO
  order. Inline and prefetched runs train on the same batches.
- **Dynamic depth** (``depth_max`` + ``autotune``): with ``autotune=True`` a
  :class:`~pytorch_operator_tpu_torch.data.feed_autotune.FeedAutotuner`
  grows the depth on measured consumer stalls and shrinks it after sustained
  headroom, inside ``[1, depth_max]``. ``set_depth`` is public too.
- **Rolling stall telemetry**: ``stats()`` reports ``feed_stall_ms_recent``,
  the mean wait over the last :data:`STALL_WINDOW` gets (the heartbeat's
  field), beside the lifetime ``feed_stall_ms_avg``.

**Streams on the card.** The default ``put``, :func:`to_device`, copies each
host array into pinned memory and issues a ``non_blocking`` copy on a side
stream of the producer thread (one a thread and device, so workers' copies
overlap), then records an event. ``get()`` makes the consumer's current
stream wait on that event and ``record_stream``\\ s each tensor to it: the
step never reads a batch before it lands, and the caching allocator never
hands its memory to another stream while the step may still use it. Each
producer thread enters the batch's device before its copy.

Two entry points: :class:`DevicePrefetcher` (``produce()`` returns a host
batch, ``put()`` maps it to the device) and :func:`prefetch_to_device`, a
drop-in for a loader's ``next_batch()`` that copies the loader's borrowed
slot inside the serialized produce turn.

``close()`` is prompt from every side: a consumer blocked in ``get()`` is
woken and raises ``RuntimeError("prefetcher is closed")``, and producer
threads exit at their next gate.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import obs
from .feed_autotune import FeedAutotuner

# Gets in the rolling stall window: a burst dominates it, one noisy get
# does not.
STALL_WINDOW = 64

_side_streams = threading.local()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class InFlight:
    """A device batch whose copy was issued on a side stream: ``tree`` is
    not to be read before the consumer's stream waits on ``event``."""

    __slots__ = ("tree", "event", "device")

    def __init__(self, tree, event, device):
        self.tree, self.event, self.device = tree, event, device


def _side_stream(device: torch.device):
    streams = getattr(_side_streams, "by_device", None)
    if streams is None:
        streams = _side_streams.by_device = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def to_device(tree: Any, device="cuda") -> Any:
    """The default ``put``: a tree of numpy arrays or CPU tensors onto
    ``device``. On the CPU, tensors that own their bytes. On a CUDA device,
    each leaf is copied into pinned memory and sent with a ``non_blocking``
    copy on this thread's side stream; returns an :class:`InFlight` that
    ``get()`` hands over to the consumer's stream."""
    device = torch.device(device)
    if device.type == "cpu":
        return _map(lambda x: torch.from_numpy(np.array(x, copy=True)) if isinstance(x, np.ndarray)
                    else x.detach().clone(), tree)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with torch.cuda.device(device):
        stream = _side_stream(device)
        with torch.cuda.stream(stream):
            out = _map(
                lambda x: torch.as_tensor(x).pin_memory().to(device, non_blocking=True), tree
            )
            event = torch.cuda.Event()
            event.record(stream)
    return InFlight(out, event, device)


def _hand_over(leaf):
    if not isinstance(leaf, InFlight):
        return leaf
    stream = torch.cuda.current_stream(leaf.device)
    stream.wait_event(leaf.event)
    _map(lambda t: t.record_stream(stream), leaf.tree)
    return leaf.tree


def _deliver(item):
    """Hand every :class:`InFlight` in ``item`` over to the consumer's
    current stream: wait on its copy's event, and mark each tensor as used
    by that stream."""
    return _map(_hand_over, item)


class DevicePrefetcher:
    """Pipelined background device feed over an arbitrary host-batch source.

    ``produce()`` runs serialized in FIFO ticket order on the producer pool;
    ``put()`` (default :func:`to_device` onto ``device``) runs concurrently
    across ``workers`` threads; ``get()`` pops ready batches in production
    order from a reorder buffer. At most ``depth`` batches are in flight
    ahead of the consumer.

    A ``produce``/``put`` exception is raised from ``get()`` at the failed
    batch's position, after every earlier batch has been delivered, and at
    every later ``get()``.
    """

    def __init__(
        self,
        produce: Callable[[], Any],
        *,
        put: Optional[Callable[[Any], Any]] = None,
        device="cuda",
        depth: int = 2,
        depth_max: Optional[int] = None,
        workers: int = 1,
        autotune: bool = False,
        autotuner: Optional[FeedAutotuner] = None,
        name: str = "device-prefetch",
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.workers = int(workers)
        self.depth_max = max(depth, int(depth_max or depth))
        self._depth = depth
        if autotune and autotuner is None:
            autotuner = FeedAutotuner(self.depth_max, initial=depth)
        self._autotuner = autotuner
        self._produce = produce
        self._put = put or functools.partial(to_device, device=device)
        # Consumer side: the reorder buffer and the delivery cursor, under
        # one condition that close() and the producers notify.
        self._cv = threading.Condition()
        self._buf: dict = {}  # seq -> ready batch
        self._ticket = 0  # next seq a producer claims
        self._next_out = 0  # next seq the consumer receives
        self._stop = False
        self._err: Optional[BaseException] = None
        self._err_seq: Optional[int] = None
        # Producer side: produce() calls run in claimed ticket order.
        self._pcv = threading.Condition()
        self._produce_turn = 0
        self._stats_lock = threading.Lock()
        self._stats = {"batches": 0, "produce_s": 0.0, "put_s": 0.0, "gets": 0, "get_wait_s": 0.0}
        self._recent: deque = deque(maxlen=STALL_WINDOW)
        self._threads = [
            threading.Thread(target=self._fill, name=f"{name}-{i}", daemon=True)
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()

    # ---- depth control ----

    @property
    def depth(self) -> int:
        """The current lookahead bound (live under autotuning)."""
        return self._depth

    def set_depth(self, depth: int) -> None:
        """Retarget the lookahead, clamped to ``[1, depth_max]``; takes effect
        at the producers' next gate. Shrinking drops no produced batch."""
        depth = max(1, min(int(depth), self.depth_max))
        with self._cv:
            if depth != self._depth:
                self._depth = depth
                self._cv.notify_all()

    # ---- producer pool ----

    def _record_failure(self, seq: int, e: BaseException) -> None:
        with self._cv:
            if self._err_seq is None or seq < self._err_seq:
                self._err, self._err_seq = e, seq
            self._cv.notify_all()
        with self._pcv:
            self._pcv.notify_all()

    def _fill(self) -> None:
        while True:
            # Gate: claim a ticket only while fewer than `depth` batches are
            # in flight ahead of the consumer.
            with self._cv:
                while (
                    not self._stop
                    and self._err is None
                    and (self._ticket - self._next_out) >= self._depth
                ):
                    self._cv.wait(0.2)
                if self._stop or self._err is not None:
                    return
                seq = self._ticket
                self._ticket += 1
            # produce #seq runs before produce #seq+1, whichever worker holds
            # which ticket.
            with self._pcv:
                while self._produce_turn != seq and not self._stop and self._err is None:
                    self._pcv.wait(0.2)
                if self._stop or self._err is not None:
                    return
                try:
                    t0 = time.perf_counter()
                    with obs.span("feed_produce", cat="data"):
                        batch = self._produce()
                    t1 = time.perf_counter()
                except BaseException as e:  # noqa: BLE001 — delivered to the consumer
                    self._record_failure(seq, e)
                    return
                self._produce_turn += 1
                self._pcv.notify_all()
            # The concurrent tail: casts, copies and transfers overlap across
            # workers.
            try:
                with obs.span("feed_put", cat="data"):
                    item = self._put(batch)
                t2 = time.perf_counter()
            except BaseException as e:  # noqa: BLE001 — delivered to the consumer
                self._record_failure(seq, e)
                return
            with self._stats_lock:
                self._stats["batches"] += 1
                self._stats["produce_s"] += t1 - t0
                self._stats["put_s"] += t2 - t1
            with self._cv:
                self._buf[seq] = item
                self._cv.notify_all()

    # ---- consumer (step path) ----

    def get(self) -> Any:
        """The next batch, in production order. Blocks only when the
        producers have fallen behind; raises promptly if the prefetcher is
        closed underneath a blocked consumer."""
        t0 = time.perf_counter()
        with self._cv:
            while True:
                if self._stop:
                    raise RuntimeError("prefetcher is closed")
                if self._next_out in self._buf:
                    item = self._buf.pop(self._next_out)
                    self._next_out += 1
                    self._cv.notify_all()
                    break
                if self._err is not None and self._next_out >= (self._err_seq or 0):
                    # Every batch produced before the failure has been
                    # delivered: the failure surfaces at its position.
                    raise self._err
                self._cv.wait()
        waited = time.perf_counter() - t0
        with self._stats_lock:
            self._stats["gets"] += 1
            self._stats["get_wait_s"] += waited
            self._recent.append(waited)
        if waited > 1e-4:
            rec = obs.tracer()
            if rec is not None:
                rec.emit("feed_wait", "data", time.time() - waited, waited)
        if self._autotuner is not None:
            new = self._autotuner.observe(1000.0 * waited)
            if new != self._depth:
                self.set_depth(new)
        return _deliver(item)

    def stats(self) -> dict:
        """Cumulative feed accounting and two step-loop stall meters:
        ``feed_stall_ms_avg`` (lifetime mean a get) and
        ``feed_stall_ms_recent`` (mean over the last :data:`STALL_WINDOW`
        gets, the heartbeat's field); ``depth`` is the live lookahead."""
        with self._stats_lock:
            s = dict(self._stats)
            recent = list(self._recent)
        s["feed_stall_ms_avg"] = 1000.0 * s["get_wait_s"] / max(s["gets"], 1)
        s["feed_stall_ms_recent"] = 1000.0 * sum(recent) / len(recent) if recent else 0.0
        s["depth"] = self._depth
        s["workers"] = self.workers
        return s

    def close(self) -> None:
        """Stop the producer pool and drop buffered batches. Idempotent. A
        consumer blocked in ``get()`` is woken and raises ``RuntimeError``."""
        with self._cv:
            if self._stop:
                return
            self._stop = True
            self._buf.clear()
            self._cv.notify_all()
        # A worker stuck inside a blocking produce() holds the produce lock;
        # close does not inherit its stall (gate waits are timed and see
        # _stop within 0.2 s).
        if self._pcv.acquire(timeout=0.2):
            try:
                self._pcv.notify_all()
            finally:
                self._pcv.release()
        for t in self._threads:
            t.join(timeout=1.0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PrefetchedLoader:
    """The loader contract over a :class:`DevicePrefetcher` — see
    :func:`prefetch_to_device`."""

    def __init__(self, loader, depth: int = 2, *, put=None, device="cuda",
                 depth_max: Optional[int] = None, workers: int = 1, autotune: bool = False):
        self.loader = loader

        def produce():
            epoch, index, fields = loader.next_batch()
            # Copy the borrowed slot inside the serialized produce turn,
            # before the next ticket's next_batch() recycles it.
            return epoch, index, {k: np.array(v, copy=True) for k, v in fields.items()}

        apply_put = put or functools.partial(to_device, device=device)
        self._pf = DevicePrefetcher(
            produce,
            put=lambda item: (item[0], item[1], apply_put(item[2])),
            depth=depth,
            depth_max=depth_max,
            workers=workers,
            autotune=autotune,
        )

    @property
    def batches_per_epoch(self) -> int:
        return self.loader.batches_per_epoch

    def stats(self) -> dict:
        return self._pf.stats()

    def next_batch(self):
        """The wrapped loader's contract, with ``fields`` already on the
        device and owned by the caller (no borrow to respect)."""
        return self._pf.get()

    def close(self) -> None:
        self._pf.close()
        self.loader.close()

    def __enter__(self) -> "PrefetchedLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_to_device(loader, depth: int = 2, *, put=None, device="cuda",
                       depth_max: Optional[int] = None, workers: int = 1,
                       autotune: bool = False) -> PrefetchedLoader:
    """Wrap a batch loader in a pipelined device feed. ``put(fields) ->
    device fields`` defaults to :func:`to_device` onto ``device``;
    ``workers`` sizes the producer pool (batch order unchanged);
    ``depth_max``/``autotune`` enable the stall-driven depth controller. The
    wrapper owns the loader: ``close()`` closes both."""
    return PrefetchedLoader(loader, depth, put=put, device=device, depth_max=depth_max,
                            workers=workers, autotune=autotune)
