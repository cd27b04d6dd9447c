"""Checkpoint save/restore shared by the port's workloads — the port of
``pytorch_operator_tpu/checkpoint/manager.py``.

Checkpointing is the workload's half of resume: the supervisor injects a
per-job directory (``TPUJOB_CHECKPOINT_DIR``) that survives gang restarts and
resubmission, and a workload calls :meth:`CheckpointManager.restore_or_none`
at startup. The JAX package writes orbax; the machine with the card has no
orbax (nor jax, nor tensorstore), so the port's backend is ``torch.save``:

    <root>/<step>/<key>.pt     one file a top-level key of the state
                               (``params.pt``, ``opt_state.pt``), CPU tensors
    <root>/<step>/meta.json    the step, the keys and the format
    <root>/<step>.digest       the checksum sidecar (``integrity.py``)

A step is written into a directory whose name is not digits and renamed to
``<step>`` when whole, so ``integrity.list_steps`` (which counts digit-named
directories only) never sees a half-written step. The sidecar is written
last. The layout of steps, sidecars and fences is the JAX package's, so its
reconciler (``controller/reconciler.py``) judges a port checkpoint as it
judges its own; the files inside a step are this package's own format, which
the JAX package cannot restore, nor the port an orbax step.

**A world of more than one process** (``num_processes`` > 1): every rank
writes its own part of a step into the shared directory,
``<root>/<step>/<key>.r<rank>.pt``, where each DTensor (an FSDP2 shard) and
each :class:`~..parallel.sharding.Block` (a tp block, FSDP2's rows of it,
an optimizer statistic's block) is a record of its local part, its offset
on every dim and the global shape; a part that several ranks hold (over
``dp``, or over ``tp`` for a replicated tensor) is written by the rank at
coordinate 0 of those axes only. The step is fenced (``<step>.inflight``) by every rank
before its first byte, and the primary (rank 0) writes ``meta.json`` (with
the world size) and, only after the ``written`` barrier of
:func:`~.multihost.make_multihost_commit` (every rank's files durable), the
sidecar, which clears the fence: blocking or asynchronous alike. Restore
memory-maps the ranks' files and, for a DTensor or a Block in the caller's
``state_like``, copies only the block this rank holds in the new layout out
of the records that overlap it (a rank reads its share of the step, not
the whole of it); elsewhere it assembles the whole tensor. A step restores
at any world size, a single process included.

``save(block=False)`` commits on the background pipeline of
``async_writer.py`` — every step still verified, a ``checkpoint_committed``
record a commit, a ``checkpoint_save_failed`` record (never an exception
into the step loop) for a save lost after its retries. Every read and every
blocking save drains that pipeline first, so no caller sees a half-committed
step and the step files are touched by one thread at a time.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from .. import faults, obs
from ..backoff import Backoff, retry_call
from ..parallel.sharding import Block
from ..runtime.rendezvous import report, report_checkpoint_committed
from . import integrity
from .async_writer import AsyncCheckpointWriter, snapshot_to_host, stage_mutable_leaves
from .multihost import make_multihost_commit

FORMAT = "torch.save"
# The key of a part's record in a rank's file: its local block (or None
# where another rank writes the same block), "offset" (one a dim; a bare
# int, dim 0's, in steps written before tp) and "shape".
SHARD = "__shard__"
# Each wait of a multi-process commit's barrier: a step whose ranks have
# not all written their files by then is not committed.
BARRIER_TIMEOUT_S = 300.0


def job_checkpoint_dir() -> Optional[Path]:
    """The supervisor-injected per-job checkpoint directory, if any."""
    d = os.environ.get("TPUJOB_CHECKPOINT_DIR")
    return Path(d) if d else None


def _to_cpu(tree):
    """``tree`` (nested dicts, lists, tuples) with every tensor detached on
    the CPU. A CPU tensor comes back as itself, not a copy: only a save that
    writes before returning may pass live tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _shape(v) -> tuple:
    """The (global) shape of a saved tensor or of a :data:`SHARD` record."""
    return tuple(v["shape"]) if isinstance(v, dict) else tuple(v.shape)


def _check_like(key: str, got, like) -> None:
    """Raise ValueError when a restored flat tensor dict (or one rank's
    records of it) does not have the names and (whole) shapes of ``like``
    (what the caller will load it into)."""
    if not (isinstance(like, dict) and like
            and all(isinstance(v, (torch.Tensor, Block)) for v in like.values())):
        return
    for name in sorted(set(like) | set(got)):
        a, b = got.get(name), like.get(name)
        if a is None or b is None or _shape(a) != tuple(b.shape):
            raise ValueError(
                f"checkpoint {key!r} does not match: first mismatch at {name}: checkpoint has "
                f"{'nothing' if a is None else _shape(a)}, expected "
                f"{'nothing' if b is None else tuple(b.shape)}"
            )


def _rank_part(tree):
    """The tree this rank writes: each DTensor and each Block becomes a
    :data:`SHARD` record of its local part (a view: the snapshot copies
    it), or of None where a rank at a lower coordinate of the axes that
    hold the same part writes it."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        tree = Block.of(tree)
    if isinstance(tree, Block):
        return {SHARD: tree.data if tree.writer else None, "offset": list(tree.offsets),
                "shape": list(tree.shape)}
    if isinstance(tree, dict):
        return {k: _rank_part(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rank_part(v) for v in tree)
    return tree


def _offsets(rec) -> list:
    """A record's offset on every dim (a bare int is dim 0's)."""
    a = rec["offset"]
    return list(a) if isinstance(a, (list, tuple)) else [a] + [0] * (len(rec["shape"]) - 1)


def _rows(trees, like):
    """The value of one tensor from the ranks' trees of a step: each a
    :data:`SHARD` record, or (a single-process step) the whole tensor. For a
    DTensor or a Block ``like``, this rank's block of its layout (a DTensor
    on ``like``'s device where ``like`` holds one, else a CPU tensor);
    otherwise the whole tensor. Only the records that overlap that block
    are read, and every element of it must be covered by one (or
    ValueError)."""
    from torch.distributed.tensor import DTensor

    recs = [t if isinstance(t, dict) else {SHARD: t, "offset": 0, "shape": list(t.shape)} for t in trees]
    shape = list(recs[0]["shape"])
    if isinstance(like, DTensor):
        like = Block.of(like)
    if isinstance(like, Block):
        start, size = list(like.offsets), list(like.data.shape)
    else:
        start, size = [0] * len(shape), shape
    out, covered = None, 0
    for rec in recs:
        local = rec[SHARD]
        if local is None:
            continue
        if out is None:
            out = torch.empty(size, dtype=local.dtype)
        a = _offsets(rec)
        lo = [max(x, s) for x, s in zip(a, start)]
        hi = [min(x + n, s + z) for x, n, s, z in zip(a, local.shape, start, size)]
        if all(l < h for l, h in zip(lo, hi)):
            out[tuple(slice(l - s, h - s) for l, h, s in zip(lo, hi, start))] = local[
                tuple(slice(l - x, h - x) for l, h, x in zip(lo, hi, a))
            ]
            covered += math.prod(h - l for l, h in zip(lo, hi))
    if out is None or covered < math.prod(size):
        raise ValueError(
            f"the ranks' parts cover {covered} of the {math.prod(size)} elements of the block at "
            f"{start} of size {size} to restore of {shape}"
        )
    if not (isinstance(like, Block) and isinstance(like.local, DTensor)):
        return out
    t = like.local
    return DTensor.from_local(
        out.to(t.to_local().device), t.device_mesh, t.placements, run_check=False,
        shape=t.shape, stride=t.stride(),
    )


def _fit(trees, like):
    """One tree from the ranks' trees of a step (a single-process step: its
    one tree), shaped for ``like`` (the caller's tree, or None): each
    :data:`SHARD` record, and a whole tensor where ``like`` holds a DTensor,
    through :func:`_rows`; any other leaf is the same on every rank and
    taken from the first."""
    from torch.distributed.tensor import DTensor

    first = trees[0]
    if (isinstance(first, dict) and SHARD in first) or (
        isinstance(first, torch.Tensor) and isinstance(like, (DTensor, Block))
    ):
        return _rows(trees, like)
    if isinstance(first, dict):
        sub = like if isinstance(like, dict) else {}
        return {k: _fit([t[k] for t in trees], sub.get(k)) for k in first}
    if isinstance(first, (list, tuple)):
        sub = like if isinstance(like, (list, tuple)) and len(like) == len(first) else [None] * len(first)
        return type(first)(_fit([t[i] for t in trees], lk) for i, lk in enumerate(sub))
    return first


class CheckpointManager:
    """Step-keyed checkpoints of a train state: a dict whose top-level
    values (``params``: a model's ``state_dict``; ``opt_state``: the
    optimizer's) are each saved with ``torch.save``.

    ``staged`` is the default flavour of an asynchronous save (see
    :meth:`save`). ``process_id``/``num_processes`` place this manager in a
    world of several processes sharing ``directory`` (the module
    docstring)."""

    def __init__(
        self, directory: Path | str, max_to_keep: int = 3, create: bool = True, *,
        staged: bool = False, process_id: int = 0, num_processes: int = 1,
    ):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        self._staged = staged
        self.process_id, self.num_processes = int(process_id), int(num_processes)
        self._commit = self._commit_step
        if self.num_processes > 1:
            self._multihost = make_multihost_commit(
                self.directory, self._write_shard, process_id=self.process_id,
                num_processes=self.num_processes, barrier_timeout=BARRIER_TIMEOUT_S,
                report=report, on_abort=self._abort_shard,
            )
            self._commit = self._commit_multi
        # Made at the first asynchronous save: one commit thread, so
        # asynchronous saves commit in submission order.
        self._writer: Optional[AsyncCheckpointWriter] = None
        if create:
            # parents=True: the supervisor nests checkpoint directories
            # several levels under its state directory.
            self.directory.mkdir(parents=True, exist_ok=True)
        elif not self.directory.is_dir():
            # A read-only opener (generate --restore) leaves no stray
            # directory behind a mistyped path.
            raise FileNotFoundError(f"no checkpoint under {self.directory}")

    def _drain(self) -> None:
        """Barrier: every asynchronous save submitted so far has committed
        or failed (and been reported)."""
        if self._writer is not None:
            self._writer.wait()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        self._drain()
        steps = integrity.list_steps(self.directory)
        if self.num_processes > 1:
            # A step another rank is still writing is fenced until the
            # primary's sidecar: not a step of this world yet, so that every
            # rank sees the same steps (and decides alike whether to save).
            steps = [s for s in steps if not integrity.inflight_path(self.directory, s).exists()]
        return steps

    def last_committed_step(self) -> Optional[int]:
        """Newest step whose asynchronous commit (sidecar included)
        finished, without draining: the live-telemetry peek."""
        return None if self._writer is None else self._writer.last_committed_step()

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(int(step))

    def _commit_step(self, step: int, state: Dict[str, Any], fault) -> None:
        """One durable, verified step commit: the shared tail of a blocking
        save (on the caller's thread) and an asynchronous one (on the
        writer's commit thread).

        Transient I/O failures are retried on the shared backoff schedule;
        each retry first clears the partial step so the next attempt starts
        clean, and retry exhaustion (an ``enospc`` fault: every attempt
        fails) clears it before re-raising, so a half-written step can never
        be taken for a legacy unverified one. The sidecar commits last."""
        staging = self.directory / f".step-{int(step)}.partial"
        host = {key: _to_cpu(value) for key, value in state.items()}

        def attempt():
            nonlocal fault
            if fault == "fail":
                fault = None  # transient: only the first attempt fails
                raise OSError("injected transient checkpoint write failure")
            if fault == "enospc":
                import errno

                # Persistent: disk-full does not heal on a retry schedule.
                raise OSError(errno.ENOSPC, "injected: no space left on device")
            staging.mkdir()
            for key, value in host.items():
                torch.save(value, staging / f"{key}.pt")
            (staging / "meta.json").write_text(
                json.dumps({"step": int(step), "keys": sorted(host), "format": FORMAT}) + "\n"
            )
            target = self._step_dir(step)
            if target.exists():
                # Saving a step again (a resumed run reaching a step that a
                # corrupt checkpoint held): the new bytes replace the old.
                integrity.sidecar_path(self.directory, step).unlink(missing_ok=True)
                shutil.rmtree(target)
            staging.rename(target)

        def clear_partial(_exc, _attempt):
            shutil.rmtree(staging, ignore_errors=True)

        clear_partial(None, None)
        try:
            retry_call(
                attempt,
                backoff=Backoff(base_s=0.05, cap_s=2.0, seed=step),
                attempts=3,
                retry_on=(OSError,),
                on_retry=clear_partial,
            )
        except OSError:
            clear_partial(None, None)
            raise
        integrity.write_sidecar(self.directory, step)
        if fault == "torn":
            # Damage the committed bytes under the fresh sidecar: the
            # stand-in for a torn write that the verified restore must skip.
            integrity.corrupt_step(self.directory, step)
        if self.max_to_keep:
            # Not all_steps(): this may run on the commit thread, which
            # must not wait for itself.
            for old in integrity.list_steps(self.directory)[: -self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        integrity.prune_stale_sidecars(self.directory)

    def _rank_file(self, step: int, key: str, rank: int) -> Path:
        return self._step_dir(step) / f"{key}.r{rank}.pt"

    def _write_shard(self, step: int, state: Dict[str, Any], fault) -> None:
        """This rank's half of a multi-process commit: its files of
        ``step``, each written under a temporary name and renamed (the step
        is fenced meanwhile); the primary also writes ``meta.json`` and
        drops files of this step that no rank of this world writes (a
        previous life's, of another world size). Transient I/O failures are
        retried as in a single-process commit."""
        d = self._step_dir(step)
        host = {key: _to_cpu(value) for key, value in state.items()}

        def put(path: Path, write) -> None:
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            write(tmp)
            tmp.replace(path)

        def attempt():
            nonlocal fault
            if fault == "fail":
                fault = None
                raise OSError("injected transient checkpoint write failure")
            if fault == "enospc":
                import errno

                raise OSError(errno.ENOSPC, "injected: no space left on device")
            d.mkdir(parents=True, exist_ok=True)
            for key, value in host.items():
                put(self._rank_file(step, key, self.process_id), lambda p: torch.save(value, p))
            if self.process_id == 0:
                mine = {f"{k}.r{r}.pt" for k in host for r in range(self.num_processes)}
                for f in d.glob("*.pt"):
                    if f.name not in mine:
                        f.unlink(missing_ok=True)
                meta = {"step": int(step), "keys": sorted(host), "format": FORMAT,
                        "world": self.num_processes}
                put(d / "meta.json", lambda p: p.write_text(json.dumps(meta) + "\n"))

        retry_call(
            attempt,
            backoff=Backoff(base_s=0.05, cap_s=2.0, seed=step),
            attempts=3,
            retry_on=(OSError,),
            on_retry=lambda _exc, _attempt: self._abort_shard(step),
        )

    def _abort_shard(self, step: int) -> None:
        """Remove this rank's files of ``step`` (a failed write: no bytes of
        it may pass for part of a committed step)."""
        for f in self._step_dir(step).glob(f"*.r{self.process_id}.pt*"):
            f.unlink(missing_ok=True)

    def _commit_multi(self, step: int, state: Dict[str, Any], fault) -> None:
        """A multi-process commit: the barrier protocol, then on the primary
        the retention of old steps (and a ``torn`` fault's damage)."""
        self._multihost(step, state, fault)
        if self.process_id != 0:
            return
        if fault == "torn":
            integrity.corrupt_step(self.directory, step)
        if self.max_to_keep:
            for old in integrity.list_steps(self.directory)[: -self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        integrity.prune_stale_sidecars(self.directory)

    def _report_save_failed(self, step: int, err) -> None:
        print(
            f"[tpujob] warning: checkpoint save of step {step} failed after retries ({err}); "
            "training continues, recovery will fall back to the last verified step",
            flush=True,
        )
        report("checkpoint_save_failed", step=step, error=str(err))

    def save(
        self, step: int, state: Dict[str, Any], *, block: bool = True,
        staged: Optional[bool] = None,
    ) -> None:
        """Save ``state`` at ``step``. ``block=True`` commits before returning
        (checksum sidecar included). ``block=False`` takes a snapshot that
        owns its bytes and commits it on the asynchronous writer; the caller
        may update the state in place as soon as this returns. Two flavours
        (``staged`` defaults to the manager's):

        - eager (``staged=False``): the whole copy to host memory happens
          here, on the caller's thread;
        - staged (``staged=True``): the copies are issued here (CUDA tensors:
          into pinned host buffers on the current stream, ordered before the
          caller's next update) and the writer's snapshot thread waits for
          them.

        The ``checkpoint_write`` fault decision is made here, one occurrence
        a call, as in the JAX package; its effect lands inside the commit. An
        asynchronous commit that exhausts its retries is reported
        (``checkpoint_save_failed``) and recorded on the writer, never raised
        into the step loop."""
        fault = faults.checkpoint_write_fault()
        multi = self.num_processes > 1
        if multi:
            state = {key: _rank_part(value) for key, value in state.items()}
        if block:
            self._drain()  # commits stay in submission order
            with obs.span("ckpt_blocking_save", cat="ckpt", step=step):
                if multi:
                    # Fenced before this rank's first byte; only the
                    # primary's sidecar lifts it, and a failure keeps it.
                    integrity.mark_inflight(self.directory, step)
                self._commit(step, state, fault)
            return
        if self._writer is None:
            self._writer = AsyncCheckpointWriter(
                self._commit,
                root=self.directory,
                on_error=self._report_save_failed,
                on_commit=report_checkpoint_committed,
                clear_fence_on_error=not multi,
            )
        if self._staged if staged is None else staged:
            with obs.span("ckpt_stage_submit", cat="ckpt", step=step):
                snapshot = stage_mutable_leaves(state)
            self._writer.submit_staged(step, snapshot, fault)
            return
        with obs.span("ckpt_snapshot", cat="ckpt", step=step):
            snap = snapshot_to_host(state)
        self._writer.submit(step, snap, fault)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Drain pending asynchronous saves. True when drained; False, after
        a warning, when ``timeout`` expired with saves still pending."""
        if self._writer is None:
            return True
        drained = self._writer.wait(timeout)
        if not drained:
            print(
                f"[tpujob] warning: checkpoint drain timed out after {timeout}s with commits "
                f"still pending ({self._writer.stats()}); proceeding — the newest saves may "
                "not be durable yet",
                flush=True,
            )
        return drained

    def _resolve_step(self, step: Optional[int]) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return step

    def _load(self, step: int, key: str, like=None):
        """The value of ``key`` at ``step``, checked against and shaped for
        ``like`` (:func:`_fit`): one file, or the ranks' files of a
        multi-process step. A manager in a world of one process reads a
        single-process step whole; otherwise the files are memory-mapped, so
        that only the rows taken are read."""
        d = self._step_dir(step)
        try:
            world = int(json.loads((d / "meta.json").read_text()).get("world", 1))
        except (OSError, ValueError):
            world = 1
        paths = [d / f"{key}.pt"] if world == 1 else [
            self._rank_file(step, key, r) for r in range(world)
        ]
        missing = [p.name for p in paths if not p.exists()]
        if missing:
            raise KeyError(
                f"checkpoint at step {step} has no top-level {key!r}: missing {missing} "
                f"(files: {sorted(p.name for p in d.iterdir())})"
            )
        if world == 1 and self.num_processes == 1:
            tree = torch.load(paths[0], weights_only=True, map_location="cpu")
            _check_like(key, tree, like)
            return tree
        trees = [torch.load(p, weights_only=True, map_location="cpu", mmap=True) for p in paths]
        _check_like(key, trees[0], like)
        return _fit(trees, like)

    def restore(self, state_like: Dict[str, Any], step: Optional[int] = None) -> Dict[str, Any]:
        """The saved values of ``state_like``'s top-level keys at ``step``
        (default: the newest), as CPU tensors: the caller loads them into
        its model and optimizer (``load_state_dict``), which places them;
        where ``state_like`` holds a DTensor, this rank's rows of it as a
        DTensor of that layout. A flat tensor dict (a model's
        ``state_dict``) must have the names and shapes of ``state_like``'s,
        or this raises ValueError."""
        self._drain()
        step = self._resolve_step(step)
        out = {}
        for key, like in state_like.items():
            out[key] = self._load(step, key, like)
        return out

    def restore_subtree(self, key: str) -> tuple[int, Any]:
        """``(step, value)`` of the top-level ``key`` alone (``"params"``)
        of the newest step, as CPU tensors: only ``<key>.pt`` is read, so a
        server never reads the optimizer's moments, twice the bytes of the
        params."""
        step = self._resolve_step(None)
        return step, self._load(step, key)

    def _report_corrupt(self, step: int, fallback=None, err=None) -> None:
        """Surface a skipped corrupt step on the status channel: the
        supervisor folds ``checkpoint_corrupt`` records into job events."""
        msg = (
            f"[tpujob] warning: checkpoint step {step} failed verification"
            + (f" ({err})" if err else "")
            + (
                f"; falling back toward step {fallback}"
                if fallback is not None
                else "; no older step to fall back to"
            )
        )
        print(msg, flush=True)
        report("checkpoint_corrupt", step=step, fallback=fallback)

    def latest_verified_step(self) -> Optional[int]:
        """Newest step whose checksum sidecar still matches (a step without
        one counts as acceptable). Corrupt steps are reported and skipped."""
        steps = self.all_steps()
        return integrity.latest_verified_step(
            self.directory,
            steps,
            on_corrupt=lambda s: self._report_corrupt(
                s, fallback=max((x for x in steps if x < s), default=None)
            ),
        )

    def restore_or_none(self, state_like: Dict[str, Any]) -> Optional[tuple[int, Dict[str, Any]]]:
        """``(step, state)`` from the newest restorable checkpoint, or None.

        Steps are walked newest-first: a step whose checksum does not match
        is reported and skipped, and so is one whose restore raises (a file
        ``torch.load`` rejects, a shape that does not fit): recovery degrades
        to an older checkpoint instead of dying on the write that the crash
        itself tore."""
        steps = self.all_steps()
        for i, step in enumerate(reversed(steps)):
            older = steps[-(i + 2)] if i + 2 <= len(steps) else None
            if integrity.verify_step(self.directory, step) is False:
                self._report_corrupt(step, fallback=older)
                continue
            try:
                return step, self.restore(state_like, step)
            except Exception as e:  # noqa: BLE001 — any failure of THIS step falls back
                self._report_corrupt(step, fallback=older, err=e)
        return None

    def close(self) -> None:
        """Drain the asynchronous writer: every save submitted before close
        is durable, or reported failed, when this returns."""
        if self._writer is not None:
            self._writer.close()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
