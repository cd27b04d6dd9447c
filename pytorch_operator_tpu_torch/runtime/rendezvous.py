"""Worker-side world description and status reporting for port workloads.

The port's own copy of what a single-process workload needs from
``pytorch_operator_tpu/runtime/rendezvous.py``: the supervisor-injected
world (``WorldInfo``/``world_from_env``) and the JSONL status channel
(``report``/``report_first_step``/``report_metrics``), written in the same
record format so a port job reports to the unchanged supervisor.

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


def initialize_from_env() -> WorldInfo:
    """Describe the world this process belongs to.

    A single-process world needs no process group and returns at once. A
    multi-process world raises: joining one (``torch.distributed`` with
    nccl on CUDA, gloo on the CPU) is the ROADMAP's multi-GPU item.
    """
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
