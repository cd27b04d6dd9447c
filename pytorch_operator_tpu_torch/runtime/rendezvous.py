"""Worker-side world description and status reporting for port workloads.

The port's own copy of what a single-process workload needs from
``pytorch_operator_tpu/runtime/rendezvous.py``: the supervisor-injected
world (``WorldInfo``/``world_from_env``) and the JSONL status channel
(``report``/``report_first_step``/``report_metrics``, and the training
heartbeat ``progress_enabled``/``report_progress`` with its echo of the
supervisor's clock probe, the serve-plane load beat ``report_serve``, and
the async checkpoint's ``report_checkpoint_committed``), written in the same
record format so a port job reports to the unchanged supervisor. Two fault
sites of the JAX module come with it: ``stall_rendezvous``
(:func:`fault_stall_if_armed`, the first thing :func:`initialize_from_env`
does) and ``drop_heartbeat`` (in :func:`report_progress`).

Multi-process worlds (``torch.distributed`` over the injected c10d
variables) are a later slice: ``initialize_from_env`` raises
``NotImplementedError`` for them.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .. import faults


@dataclass
class WorldInfo:
    num_processes: int
    process_id: int
    coordinator: str
    replica_type: str
    replica_index: int
    restart_count: int
    job_key: str
    resize_generation: int = 0

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def world_from_env() -> WorldInfo:
    """Read the supervisor-injected cluster spec."""
    return WorldInfo(
        num_processes=int(os.environ.get("TPUJOB_NUM_PROCESSES", "1")),
        process_id=int(os.environ.get("TPUJOB_PROCESS_ID", "0")),
        coordinator=os.environ.get("TPUJOB_COORDINATOR_ADDRESS", "127.0.0.1:23456"),
        replica_type=os.environ.get("TPUJOB_REPLICA_TYPE", "Master"),
        replica_index=int(os.environ.get("TPUJOB_REPLICA_INDEX", "0")),
        restart_count=int(os.environ.get("TPUJOB_RESTART_COUNT", "0")),
        job_key=os.environ.get("TPUJOB_KEY", "default/local"),
        resize_generation=int(os.environ.get("TPUJOB_RESIZE_GENERATION", "0")),
    )


def fault_stall_if_armed() -> float:
    """The ``stall_rendezvous`` injection site: sleep (and report, as a
    ``fault_stall`` record) the seconds an armed fault plan asks for, and
    return them; 0.0 without a plan."""
    seconds = faults.rendezvous_stall_seconds()
    if seconds > 0:
        report("fault_stall", seconds=seconds, site="rendezvous")
        time.sleep(seconds)
    return seconds


def initialize_from_env() -> WorldInfo:
    """Describe the world this process belongs to, after the
    ``stall_rendezvous`` fault site.

    A single-process world needs no process group and returns at once. A
    multi-process world raises: joining one (``torch.distributed`` with
    nccl on CUDA, gloo on the CPU) is the ROADMAP's multi-GPU item.
    """
    fault_stall_if_armed()
    world = world_from_env()
    if world.num_processes > 1:
        raise NotImplementedError(
            f"multi-process world ({world.num_processes} processes) is not "
            "supported by the port yet: see ROADMAP.md, 'multi-GPU, "
            "ring/ulysses, MoE, pp'"
        )
    return world


# ---- status reporting (workload → supervisor) ----


def _status_path() -> Optional[Path]:
    d = os.environ.get("TPUJOB_STATUS_DIR")
    if not d:
        return None
    rtype = os.environ.get("TPUJOB_REPLICA_TYPE", "Master").lower()
    idx = os.environ.get("TPUJOB_REPLICA_INDEX", "0")
    return Path(d) / f"{rtype}-{idx}.jsonl"


def report(event: str, **fields) -> None:
    """Append a status record; no-op when not running under the supervisor."""
    path = _status_path()
    if path is None:
        return
    rec = {"event": event, "ts": time.time(), **fields}
    try:
        with path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass


def report_first_step(step: int = 0) -> None:
    report("first_step", step=step)


def report_metrics(step: int, **metrics) -> None:
    report("metrics", step=step, **metrics)


def progress_enabled() -> bool:
    """Is anyone listening? Workloads gate their heartbeat on this so a
    standalone run (no supervisor, no status dir) pays no telemetry fences."""
    return _status_path() is not None


# The supervisor writes its round-trip clock probe here (obs/clock.py of the
# JAX package); each probe seq is echoed once.
_PROBE_FILE = "clock_probe.json"
_probe_echoed_seq: Optional[int] = None


def _maybe_echo_probe() -> None:
    """Echo the supervisor's clock probe once per seq: a ``clock_probe``
    record whose own ``ts`` is this replica's send time."""
    global _probe_echoed_seq
    d = os.environ.get("TPUJOB_STATUS_DIR")
    if not d:
        return
    try:
        rec = json.loads((Path(d) / _PROBE_FILE).read_text())
        probe = {"probe_ts": float(rec["probe_ts"]), "seq": int(rec["seq"])}
    except (OSError, ValueError, TypeError, KeyError):
        return
    if probe["seq"] == _probe_echoed_seq:
        return
    _probe_echoed_seq = probe["seq"]
    report("clock_probe", probe_ts=probe["probe_ts"], seq=probe["seq"])


def report_progress(
    step: int,
    *,
    loss: Optional[float] = None,
    steps_per_sec: Optional[float] = None,
    throughput: Optional[float] = None,
    unit: Optional[str] = None,
    step_time_ms: Optional[float] = None,
    feed_stall_ms: Optional[float] = None,
) -> None:
    """Live training heartbeat (step/loss/throughput), the record the
    supervisor folds into its per-job gauges. Emit every ~10 s, not every
    step: the caller pays a device fence to know the loss. A
    ``drop_heartbeat`` fault suppresses the record (the hung-world
    detector's chaos scenario)."""
    if faults.heartbeat_dropped():
        return
    fields = {}
    for name, value, digits in (
        ("loss", loss, 6),
        ("steps_per_sec", steps_per_sec, 4),
        ("throughput", throughput, 4),
        ("step_time_ms", step_time_ms, 3),
        ("feed_stall_ms", feed_stall_ms, 3),
    ):
        if value is not None:
            fields[name] = round(float(value), digits)
    if unit is not None:
        fields["unit"] = unit
    report("progress", step=step, **fields)
    _maybe_echo_probe()


def report_serve(
    requests: int,
    *,
    slots: int,
    slots_free: int,
    queued: int = 0,
    pending: int = 0,
    ttft_ms_p50: Optional[float] = None,
    ttft_ms_p99: Optional[float] = None,
    tpot_ms_p50: Optional[float] = None,
    tpot_ms_p99: Optional[float] = None,
    block_ms: Optional[float] = None,
) -> None:
    """Serve-plane load beat: slot occupancy, queue depth and latency
    percentiles of this engine replica, as the JAX package's ``serve``
    record. The supervisor's router reads the newest record per replica for
    least-loaded dispatch, and the queue_growth / batch_size_collapse
    detectors judge the same stream. ``block_ms`` is the decode-block phase:
    ms until the engine's current block completes and a slot can be filled."""
    fields: dict = {
        "slots": int(slots),
        "slots_free": int(slots_free),
        "queued": int(queued),
        "pending": int(pending),
    }
    for k, v in (
        ("ttft_ms_p50", ttft_ms_p50),
        ("ttft_ms_p99", ttft_ms_p99),
        ("tpot_ms_p50", tpot_ms_p50),
        ("tpot_ms_p99", tpot_ms_p99),
        ("block_ms", block_ms),
    ):
        if v is not None:
            fields[k] = round(float(v), 3)
    report("serve", requests=int(requests), **fields)


def report_checkpoint_committed(
    step: int,
    commit_s: float,
    queue_depth: int = 0,
    oldest_age_s: float = 0.0,
    stage_depth: int = 0,
) -> None:
    """Async-checkpoint commit telemetry, the JAX package's record: the
    supervisor folds the newest into its checkpoint-step, queue-depth,
    oldest-inflight-age and stage-depth gauges and observes ``commit_ms``
    into its commit-time histogram. ``stage_depth`` counts submitted saves
    whose snapshot has not finished."""
    report(
        "checkpoint_committed",
        step=step,
        commit_ms=round(1000.0 * commit_s, 3),
        queue_depth=int(queue_depth),
        oldest_age_s=round(oldest_age_s, 3),
        stage_depth=int(stage_depth),
    )
