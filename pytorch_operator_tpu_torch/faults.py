"""The fault-injection sites of the port's workloads — its copy of the two
sites of ``pytorch_operator_tpu/faults/`` that they run: the serving
engine's :func:`engine_step_check` (with :class:`InjectedFault`) and the
checkpoint manager's :func:`checkpoint_write_fault`.

The plan is read from ``TPUJOB_FAULT_PLAN`` the way the JAX package's
``FaultPlan.from_env`` reads it: inline JSON, or ``@/path/to/plan`` (here a
JSON file; YAML plan files are read by the JAX package's CLI, which threads
them into replicas as inline JSON). Every fault is validated as there
(known kind, no unknown fields, ``nth`` and ``times`` at least 1). A
``fail_engine_step`` fault fires on occurrences ``[nth, nth + times)`` of the
``engine_step`` site, counted per process; its target is ignored, as at the
JAX site. The ``fail``/``torn``/``enospc_checkpoint_write`` faults share the
``checkpoint_write`` site (one save, one occurrence) and, as there, match
their target against this replica (``TPUJOB_REPLICA_TYPE``/``INDEX``) and
their ``restart`` against ``TPUJOB_RESTART_COUNT``: a chaos plan fires the
same saves in both packages. Kinds whose sites the port does not have are
ignored here, as a JAX replica ignores them at these sites. No clock and no
PRNG: the same plan replays the same failures.
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

ENV_VAR = "TPUJOB_FAULT_PLAN"

# The JAX package's fault kinds (faults/plan.py), so a plan it accepts is
# accepted here and a typo is refused the same way.
KINDS = frozenset(
    {
        "crash_at_step",
        "stall_rendezvous",
        "drop_heartbeat",
        "fail_checkpoint_write",
        "torn_checkpoint_write",
        "enospc_checkpoint_write",
        "kill_replica",
        "preempt_replica",
        "kill_storm",
        "kill_supervisor",
        "drop_lease",
        "fail_spawn",
        "torn_state_write",
        "fail_engine_step",
        "overload_spool",
    }
)
NTH_KINDS = frozenset(
    {
        "drop_heartbeat",
        "fail_checkpoint_write",
        "torn_checkpoint_write",
        "enospc_checkpoint_write",
        "fail_spawn",
        "fail_engine_step",
    }
)


class InjectedFault(RuntimeError):
    """Raised by the engine-step site when a ``fail_engine_step`` fault is
    due. Carries the fault label for log forensics."""


@dataclass
class Fault:
    """One declared failure (the JAX ``Fault``'s fields and checks)."""

    kind: str
    target: str = "*"
    at: int = 0
    nth: int = 1
    times: int = 1
    seconds: float = 0.0
    exit_code: int = 9
    restart: Optional[int] = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (known: {sorted(KINDS)})"
            )
        if self.times < 1:
            raise ValueError(f"{self.kind}: times must be >= 1")
        if self.nth < 1:
            raise ValueError(f"{self.kind}: nth is 1-based, must be >= 1")

    @classmethod
    def from_dict(cls, d: dict) -> "Fault":
        extra = set(d) - set(cls.__dataclass_fields__)
        if extra:
            raise ValueError(f"fault has unknown fields: {sorted(extra)}")
        return cls(**d)

    def label(self) -> str:
        idx = f"@{self.at}" if self.kind not in NTH_KINDS else f"#{self.nth}"
        return f"{self.kind}({self.target}{idx})"


def plan_from_env(environ=None) -> Optional[List[Fault]]:
    """The faults of the plan threaded into this process, or None."""
    environ = os.environ if environ is None else environ
    raw = environ.get(ENV_VAR, "").strip()
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    d = json.loads(raw)
    if not isinstance(d, dict):
        raise ValueError(f"fault plan must be a mapping, got {type(d)}")
    return [Fault.from_dict(f) for f in d.get("faults", [])]


def target_matches(pattern: str, rtype: Optional[str], index) -> bool:
    """``worker-0`` / ``master-*`` / ``*`` against a replica id; a full
    replica name (``ns/job-worker-0``) also matches by suffix."""
    rid = f"{str(rtype or '*').lower()}-{index if index is not None else '*'}"
    return fnmatch.fnmatch(rid, pattern) or pattern.endswith("-" + rid)


class FaultInjector:
    """Evaluates one plan's ``fail_engine_step`` and checkpoint-write faults.
    Thread-safe."""

    def __init__(self, faults: List[Fault]):
        self.faults = faults
        self._lock = threading.Lock()
        self._occurrences: Dict[str, int] = {}
        self._remaining: Dict[int, int] = {i: f.times for i, f in enumerate(faults)}

    def _occurrence(self, site: str) -> int:
        """Bump and return the 1-based occurrence count of a site."""
        n = self._occurrences.get(site, 0) + 1
        self._occurrences[site] = n
        return n

    def engine_step_fault(self) -> Optional[Fault]:
        """Count one ``engine_step`` occurrence; the fault due at it, if any."""
        with self._lock:
            n = self._occurrence("engine_step")
            for i, f in enumerate(self.faults):
                if f.kind != "fail_engine_step" or self._remaining[i] <= 0:
                    continue
                if f.nth <= n < f.nth + f.times:
                    self._remaining[i] -= 1
                    return f
        return None

    _CHECKPOINT_WRITE_MODES = {
        "fail_checkpoint_write": "fail",
        "torn_checkpoint_write": "torn",
        "enospc_checkpoint_write": "enospc",
    }

    def checkpoint_write_fault(
        self, rtype=None, index=None, restart: Optional[int] = None
    ) -> Optional[str]:
        """Count one save; the mode due at it: ``"fail"`` (raise once, a
        retry recovers), ``"torn"`` (corrupt bytes under the fresh sidecar),
        ``"enospc"`` (every attempt fails, the save is lost), or None. Kinds
        are tried in that order, each fault's target matched against the
        replica when there is one (``rtype`` not None)."""
        with self._lock:
            n = self._occurrence("checkpoint_write")
            for kind, mode in self._CHECKPOINT_WRITE_MODES.items():
                for i, f in enumerate(self.faults):
                    if f.kind != kind or self._remaining[i] <= 0:
                        continue
                    if rtype is not None and not target_matches(f.target, rtype, index):
                        continue
                    if not (f.nth <= n < f.nth + f.times):
                        continue
                    if f.restart is not None and restart is not None and f.restart != restart:
                        continue
                    self._remaining[i] -= 1
                    return mode
        return None


_injector: Optional[FaultInjector] = None
_loaded = False


def injector() -> Optional[FaultInjector]:
    """The injector for this process's ``TPUJOB_FAULT_PLAN`` (read once),
    else None."""
    global _injector, _loaded
    if not _loaded:
        _loaded = True
        faults = plan_from_env()
        _injector = FaultInjector(faults) if faults is not None else None
    return _injector


def reset() -> None:
    """Forget the loaded plan and its counts; the next site call re-reads
    the env (tests)."""
    global _injector, _loaded
    _injector, _loaded = None, False


def engine_step_check() -> None:
    """Serving site: raise InjectedFault when a fail_engine_step is due."""
    inj = injector()
    if inj is None:
        return
    f = inj.engine_step_fault()
    if f is not None:
        raise InjectedFault(f"injected engine-step fault {f.label()}")


def checkpoint_write_fault() -> Optional[str]:
    """Checkpoint site: the write fault due at this save (one call is one
    occurrence), for this replica's identity; None without a plan."""
    inj = injector()
    if inj is None:
        return None
    rtype = os.environ.get("TPUJOB_REPLICA_TYPE")
    if rtype is None:
        return inj.checkpoint_write_fault()
    return inj.checkpoint_write_fault(
        rtype,
        int(os.environ.get("TPUJOB_REPLICA_INDEX", "0")),
        int(os.environ.get("TPUJOB_RESTART_COUNT", "0")),
    )
