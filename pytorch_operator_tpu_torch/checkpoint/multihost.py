"""Multi-process checkpoint commits: the primary's commit behind per-process
writer barriers — the port's own copy of
``pytorch_operator_tpu/checkpoint/multihost.py``, the same framework-free
code.

Each process of a world writes its own shard of a step, and ONE primary
(process 0) commits it: the checksum sidecar is valid only once every
process's bytes are durable. Each process runs its own commit pipeline, so
the primary's commit could otherwise reach the sidecar while another
process's shard write is still in flight, and a crash in that window would
leave a "committed" step missing a shard. This module supplies the
coordination:

- :class:`CommitBarrier` — a named rendezvous between the writer processes
  over the shared checkpoint directory: ``arrive()`` drops an atomic
  per-process marker file, ``wait_all()`` polls until every process's
  marker for that (step, phase) exists. Markers are created by atomic
  rename, so a torn arrival never counts.
- :func:`make_multihost_commit` — wraps a per-process shard-write callable
  into a commit callable for ``AsyncCheckpointWriter`` (or a blocking save):

  1. every process writes its own shard bytes for the step;
  2. every process arrives at the ``written`` barrier, and the primary
     ``wait_all()``\\ s on it — after this, ALL shards are durable;
  3. the primary alone finalizes (checksum sidecar over the assembled step
     directory, fence cleared) and arrives at ``committed``; secondaries
     ``wait_all()`` on the primary's ``committed`` marker before retiring
     the save.

  A process killed mid-protocol leaves the step fenced (never
  sidecar-verified), and every surviving process's ``wait_all()`` times out
  and FAILS the save instead of committing a torn step; restore falls back
  to the last verified step.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable, Optional

from . import integrity

# Subdirectory of the checkpoint root holding barrier markers; swept by
# the primary after each commit so a long run does not accumulate files.
BARRIER_DIR = ".barriers"


class BarrierTimeout(TimeoutError):
    """``wait_all()`` gave up: at least one process never arrived."""


class CommitBarrier:
    """File-rendezvous between a job's writer processes.

    ``root`` must be a directory every process shares (the per-job
    checkpoint dir the supervisor injects). Marker files are
    ``<root>/.barriers/<phase>-<step>.p<process_id>`` — one per
    process per (phase, step), created atomically.
    """

    def __init__(
        self,
        root,
        process_id: int,
        num_processes: int,
        *,
        poll_s: float = 0.02,
        report: Optional[Callable[..., None]] = None,
    ):
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id {process_id} outside world of {num_processes}"
            )
        self.root = Path(root) / BARRIER_DIR
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.poll_s = poll_s
        # Optional status-channel hook (rendezvous.report): barrier
        # arrivals/timeouts become visible to `tpujob why` and the
        # supervisor's event fold.
        self._report = report

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0

    def _marker(self, phase: str, step: int, pid: int) -> Path:
        return self.root / f"{phase}-{int(step)}.p{pid}"

    def arrive(self, phase: str, step: int) -> None:
        """Atomically publish this process's arrival at (phase, step).
        Idempotent — re-arrival overwrites the same marker."""
        self.root.mkdir(parents=True, exist_ok=True)
        path = self._marker(phase, step, self.process_id)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        tmp.write_text(f"{time.time()}\n")
        tmp.replace(path)

    def wait_all(
        self,
        phase: str,
        step: int,
        timeout: Optional[float] = 30.0,
        procs=None,
    ) -> None:
        """Block until every process in ``procs`` (default: the whole
        world) has arrived at (phase, step). Raises
        :class:`BarrierTimeout` — it does NOT return partially —
        because a commit past a missing writer is a torn checkpoint
        wearing a sidecar."""
        deadline = None if timeout is None else time.monotonic() + timeout
        missing = set(range(self.num_processes) if procs is None else procs)
        while missing:
            missing = {
                p for p in missing
                if not self._marker(phase, step, p).exists()
            }
            if not missing:
                return
            if deadline is not None and time.monotonic() >= deadline:
                if self._report is not None:
                    try:
                        self._report(
                            "ckpt_barrier_timeout", step=step, phase=phase,
                            missing=sorted(missing),
                        )
                    except Exception:
                        # invariant: waived — a broken telemetry hook must not mask the BarrierTimeout raised below
                        pass
                raise BarrierTimeout(
                    f"commit barrier {phase}-{step}: processes "
                    f"{sorted(missing)} never arrived within {timeout}s"
                )
            time.sleep(self.poll_s)

    def sweep(self, step: int) -> None:
        """Drop this step's markers (primary calls it after finalizing
        — the rendezvous is complete, the files are noise)."""
        for p in self.root.glob(f"*-{int(step)}.p*"):
            p.unlink(missing_ok=True)

    def sweep_older(self, phase: str, step: int) -> None:
        """Drop ``phase`` markers for steps strictly older than
        ``step``. Per-process commits are ordered, so by the time the
        primary commits ``step`` every secondary has consumed the
        ``committed`` marker of every earlier step — safe to GC."""
        prefix = f"{phase}-"
        for p in self.root.glob(f"{phase}-*.p*"):
            stem = p.name[len(prefix):].split(".p", 1)[0]
            if stem.isdigit() and int(stem) < int(step):
                p.unlink(missing_ok=True)


def make_multihost_commit(
    root,
    write_shard: Callable[[int, object, Optional[str]], None],
    *,
    process_id: int,
    num_processes: int,
    barrier_timeout: float = 30.0,
    poll_s: float = 0.02,
    report: Optional[Callable[..., None]] = None,
    on_abort: Optional[Callable[[int], None]] = None,
) -> Callable[[int, object, Optional[str]], None]:
    """Build the commit callable a multi-process world hands its
    :class:`~pytorch_operator_tpu_torch.checkpoint.async_writer.AsyncCheckpointWriter`.

    ``write_shard(step, payload, fault)`` is the per-process half: it
    must leave THIS process's bytes for ``step`` durable (and may raise
    — retries/faults are its business, exactly like a single-host
    commit callable). The returned callable adds the primary-host
    commit protocol described in the module docstring. Only the PRIMARY
    writes the checksum sidecar; secondaries never touch integrity
    files, so there is exactly one commit record per step.

    Fencing note: every process's writer fences the step in the SHARED
    root at submit (``<step>.inflight`` is one file — mark_inflight is
    atomic and idempotent across processes), and only the primary's
    sidecar write clears it; a secondary that dies pre-barrier leaves
    the step fenced because the primary's ``wait_all`` fails before the
    sidecar lands.
    """
    barrier = CommitBarrier(
        root, process_id, num_processes, poll_s=poll_s, report=report
    )

    def commit(step: int, payload, fault: Optional[str]) -> None:
        try:
            write_shard(step, payload, fault)
            barrier.arrive("written", step)
            if barrier.is_primary:
                # Only the primary collects the written barrier — it is
                # the one about to assert "all shards durable" with a
                # sidecar. Secondaries gate on the committed marker
                # below (which implies it), so the primary may sweep
                # written markers without racing a slow peer's poll.
                barrier.wait_all("written", step, timeout=barrier_timeout)
        except BaseException:
            # A shard write failure or a peer that never arrived: this
            # process's bytes must not survive to masquerade as part of
            # a committed step (the writer records the failure and
            # reports checkpoint_save_failed — same contract as a
            # single-host ENOSPC).
            if on_abort is not None:
                try:
                    on_abort(step)
                except Exception:
                    # invariant: waived — abort-callback failure must not mask the original commit failure re-raised below
                    pass
            raise
        if barrier.is_primary:
            # All shards durable: the sidecar is the commit record, and
            # writing it clears the shared inflight fence.
            integrity.write_sidecar(root, step)
            barrier.arrive("committed", step)
            # Secondaries may still be polling for THIS step's
            # committed marker; sweep the consumed written markers now
            # and older committed markers (per-process commit order
            # guarantees every secondary is past them).
            for p in range(num_processes):
                barrier._marker("written", step, p).unlink(missing_ok=True)
            barrier.sweep_older("committed", step)
        else:
            # Only the primary publishes `committed` — that one marker
            # IS the commit record's existence signal.
            barrier.wait_all(
                "committed", step, timeout=barrier_timeout, procs=(0,)
            )
            if report is not None:
                try:
                    report("ckpt_commit_ack", step=step, process=process_id)
                except Exception:
                    # invariant: waived — the ack is telemetry; the commit itself is already durable
                    pass

    return commit
