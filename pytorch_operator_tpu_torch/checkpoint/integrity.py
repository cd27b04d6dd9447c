"""Checkpoint integrity: checksum sidecars + last-verified-good scan.

The reference's resume story is "restart the pod, reload the
checkpoint" — which silently assumes the checkpoint on disk is intact.
Preempted hosts and torn writes break that assumption exactly when
recovery matters most. This module gives every step-keyed checkpoint
layout (``<root>/<step>/...files...``) a content-checksum sidecar
(``<root>/<step>.digest``) written AFTER the step commits, and a
restore-side scan that walks steps newest-first and returns the first
one whose bytes still match — the "last verified-good" fallback.

Verification is three-valued:

- ``True``   sidecar present and the digest matches — verified good;
- ``False``  sidecar present but the bytes changed — CORRUPT, skip it;
- ``None``   no sidecar (legacy checkpoint / non-blocking save) —
  unknown; accepted by default so pre-sidecar checkpoints keep
  restoring, but callers may demand strict verification.

The port's own copy of ``pytorch_operator_tpu/checkpoint/integrity.py``,
the same bytes-level code: the port's ``torch.save`` manager
(``manager.py``) writes the sidecars and fences that the JAX package's
reconciler reads (``latest_verified_step`` over the job's checkpoint
directory), so a port checkpoint is judged exactly as a JAX one.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Callable, Iterable, List, Optional

_CHUNK = 1 << 20


def step_digest(step_dir) -> str:
    """Order-independent-of-walk digest of every file under a step dir:
    blake2b over (relative path, size, content) in sorted path order."""
    step_dir = Path(step_dir)
    h = hashlib.blake2b(digest_size=16)
    files = sorted(
        p for p in step_dir.rglob("*") if p.is_file()
    )
    for p in files:
        rel = p.relative_to(step_dir).as_posix()
        h.update(rel.encode())
        h.update(b"\0")
        h.update(str(p.stat().st_size).encode())
        h.update(b"\0")
        with p.open("rb") as f:
            while True:
                chunk = f.read(_CHUNK)
                if not chunk:
                    break
                h.update(chunk)
    return h.hexdigest()


def sidecar_path(root, step: int) -> Path:
    return Path(root) / f"{int(step)}.digest"


def inflight_path(root, step: int) -> Path:
    return Path(root) / f"{int(step)}.inflight"


def mark_inflight(root, step: int) -> Path:
    """Fence a step whose async commit is in flight: until the sidecar
    lands (which clears the fence), the step is NOT committed — a crash
    mid-commit leaves the marker behind and the restore-side scan skips
    the step no matter how complete its bytes look. Atomic for the same
    reason sidecars are: a torn fence must still fence."""
    path = inflight_path(root, step)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text("inflight\n")
    tmp.replace(path)
    return path


def clear_inflight(root, step: int) -> None:
    inflight_path(root, step).unlink(missing_ok=True)


def write_sidecar(root, step: int) -> str:
    """Digest ``root/<step>`` and commit the sidecar atomically (a torn
    SIDECAR must never condemn a good checkpoint). Returns the digest.

    Also clears the step's inflight fence — the sidecar IS the commit
    record, so a stale fence from a previous life's interrupted async
    save must not condemn the step a new life just re-saved. Ordering
    (sidecar first, then unfence) errs conservative: a crash between
    the two leaves a good step fenced, and recovery falls back one
    step rather than trusting an ambiguous one."""
    digest = step_digest(Path(root) / str(int(step)))
    path = sidecar_path(root, step)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(digest + "\n")
    tmp.replace(path)
    clear_inflight(root, step)
    return digest


def verify_step(root, step: int) -> Optional[bool]:
    """True = verified good; False = corrupt/uncommitted; None = no
    sidecar (legacy checkpoint — accepted by default)."""
    if inflight_path(root, step).exists():
        # An async commit started and never finished (the writer clears
        # the fence when the sidecar lands): the step is uncommitted,
        # whatever bytes the crash left behind.
        return False
    path = sidecar_path(root, step)
    try:
        expected = path.read_text().strip()
    except OSError:
        return None
    if not expected:
        return False  # torn sidecar: treat as corrupt, never as "unknown"
    step_dir = Path(root) / str(int(step))
    if not step_dir.is_dir():
        return False  # sidecar survived its checkpoint: gone = corrupt
    return step_digest(step_dir) == expected


def list_steps(root) -> List[int]:
    """Integer-named step directories under a checkpoint root, sorted."""
    root = Path(root)
    if not root.is_dir():
        return []
    out = []
    for p in root.iterdir():
        if p.is_dir() and p.name.isdigit():
            out.append(int(p.name))
    return sorted(out)


def latest_verified_step(
    root,
    steps: Optional[Iterable[int]] = None,
    *,
    require_sidecar: bool = False,
    on_corrupt: Optional[Callable[[int], None]] = None,
) -> Optional[int]:
    """Newest step that passes verification, scanning newest-first.

    Corrupt steps (and, under ``require_sidecar``, unverifiable ones)
    are skipped after calling ``on_corrupt(step)`` — the hook the
    restore path uses to surface a "skipped corrupt checkpoint" event.
    """
    steps = list_steps(root) if steps is None else sorted(steps)
    for step in reversed(list(steps)):
        ok = verify_step(root, step)
        if ok is True or (ok is None and not require_sidecar):
            return step
        if on_corrupt is not None:
            on_corrupt(step)
    return None


def prune_stale_sidecars(root) -> None:
    """Drop sidecars and inflight fences whose step directory is gone
    (max_to_keep GC, or a commit that failed after cleanup)."""
    root = Path(root)
    live = {str(s) for s in list_steps(root)}
    for suffix in (".digest", ".inflight"):
        for p in root.glob("*" + suffix):
            if p.name[: -len(suffix)] not in live:
                p.unlink(missing_ok=True)


def corrupt_step(root, step: int, *, mode: str = "flip") -> Path:
    """Damage a committed step IN PLACE, leaving its sidecar stale — the
    torn-write simulator shared by the ``torn_checkpoint_write`` fault
    and the corruption tests. ``mode``: ``flip`` inverts a byte mid-file;
    ``truncate`` cuts the file in half. Returns the damaged path."""
    step_dir = Path(root) / str(int(step))
    files = sorted(p for p in step_dir.rglob("*") if p.is_file())
    if not files:
        raise FileNotFoundError(f"no files under {step_dir}")
    # Deterministic victim: the largest file, ties broken by path.
    victim = max(files, key=lambda p: (p.stat().st_size, str(p)))
    data = bytearray(victim.read_bytes())
    if mode == "truncate":
        # invariant: waived — deliberate in-place corruption; this simulator exists to defeat atomicity
        victim.write_bytes(bytes(data[: len(data) // 2]))
    elif mode == "flip":
        if not data:
            data = bytearray(b"\xff")
        else:
            data[len(data) // 2] ^= 0xFF
        # invariant: waived — deliberate in-place corruption; this simulator exists to defeat atomicity
        victim.write_bytes(bytes(data))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return victim
