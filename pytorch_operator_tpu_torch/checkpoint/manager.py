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

Not ported yet (ROADMAP.md, the rest of slice 2's left-outs): asynchronous
saves (``save(block=False)``, ``async_writer.py``) and with them the
``checkpoint_committed`` record.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from .. import faults
from ..backoff import Backoff, retry_call
from ..runtime.rendezvous import report
from . import integrity

FORMAT = "torch.save"


def job_checkpoint_dir() -> Optional[Path]:
    """The supervisor-injected per-job checkpoint directory, if any."""
    d = os.environ.get("TPUJOB_CHECKPOINT_DIR")
    return Path(d) if d else None


def _to_cpu(tree):
    """A copy of ``tree`` (nested dicts, lists, tuples) with every tensor
    detached on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _check_like(key: str, got, like) -> None:
    """Raise ValueError when a restored flat tensor dict does not have the
    names and shapes of ``like`` (what the caller will load it into)."""
    if not (isinstance(like, dict) and like and all(isinstance(v, torch.Tensor) for v in like.values())):
        return
    for name in sorted(set(like) | set(got)):
        a, b = got.get(name), like.get(name)
        if a is None or b is None or tuple(a.shape) != tuple(b.shape):
            raise ValueError(
                f"checkpoint {key!r} does not match: first mismatch at {name}: checkpoint has "
                f"{'nothing' if a is None else tuple(a.shape)}, expected "
                f"{'nothing' if b is None else tuple(b.shape)}"
            )


class CheckpointManager:
    """Step-keyed checkpoints of a train state: a dict whose top-level
    values (``params``: a model's ``state_dict``; ``opt_state``: the
    optimizer's) are each saved with ``torch.save``."""

    def __init__(self, directory: Path | str, max_to_keep: int = 3, create: bool = True):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        if create:
            # parents=True: the supervisor nests checkpoint directories
            # several levels under its state directory.
            self.directory.mkdir(parents=True, exist_ok=True)
        elif not self.directory.is_dir():
            # A read-only opener (generate --restore) leaves no stray
            # directory behind a mistyped path.
            raise FileNotFoundError(f"no checkpoint under {self.directory}")

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        return integrity.list_steps(self.directory)

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(int(step))

    def _commit_step(self, step: int, state: Dict[str, Any], fault) -> None:
        """One durable, verified step commit.

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
            for old in self.all_steps()[: -self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        integrity.prune_stale_sidecars(self.directory)

    def save(self, step: int, state: Dict[str, Any], *, block: bool = True) -> None:
        """Save ``state`` at ``step`` and wait for the commit (checksum
        sidecar included). The ``checkpoint_write`` fault decision is made
        here, one occurrence a call, as in the JAX package."""
        if not block:
            raise NotImplementedError(
                "save(block=False) is not ported yet (ROADMAP.md: the rest of slice 2's "
                "left-outs, --async-checkpoint)"
            )
        self._commit_step(step, state, faults.checkpoint_write_fault())

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Barrier over pending saves: every save here is blocking, so
        there is never one pending."""
        return True

    def _resolve_step(self, step: Optional[int]) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return step

    def _load(self, step: int, key: str):
        path = self._step_dir(step) / f"{key}.pt"
        if not path.exists():
            raise KeyError(
                f"checkpoint at step {step} has no top-level {key!r} "
                f"(files: {sorted(p.name for p in self._step_dir(step).iterdir())})"
            )
        return torch.load(path, weights_only=True, map_location="cpu")

    def restore(self, state_like: Dict[str, Any], step: Optional[int] = None) -> Dict[str, Any]:
        """The saved values of ``state_like``'s top-level keys at ``step``
        (default: the newest), as CPU tensors: the caller loads them into
        its model and optimizer (``load_state_dict``), which places them. A
        flat tensor dict (a model's ``state_dict``) must have the names and
        shapes of ``state_like``'s, or this raises ValueError."""
        step = self._resolve_step(step)
        out = {}
        for key, like in state_like.items():
            out[key] = self._load(step, key)
            _check_like(key, out[key], like)
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
        """Nothing is pending at close: every save blocks."""

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
