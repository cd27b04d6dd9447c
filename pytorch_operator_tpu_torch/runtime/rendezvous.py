"""Worker-side rendezvous and status reporting for port workloads — the port
of ``pytorch_operator_tpu/runtime/rendezvous.py``.

- The supervisor-injected world (``WorldInfo``/``world_from_env``) and its
  join: :func:`initialize_from_env` forms a ``torch.distributed`` process
  group at the world's coordinator (``TPUJOB_COORDINATOR_ADDRESS``, rank
  ``TPUJOB_PROCESS_ID``, size ``TPUJOB_NUM_PROCESSES``), retried on the
  :func:`join_backoff` schedule, inside a ``rendezvous_join`` span and
  reported as a ``rendezvous_join`` record. Its backend follows one rule,
  reported with the rank's device (:func:`choose_backend`): gloo on the CPU,
  nccl when every rank has a GPU of its own, gloo when ranks share one.
- The elastic resize fence (``ResizeSignal``, :func:`read_resize_record`,
  :func:`poll_resize`, :func:`adopt_resize`, :func:`exit_for_resize`) and
  the deterministic exit of a multi-process world (:func:`finalize`).
- The JSONL status channel (``report``/``report_first_step``/
  ``report_metrics``, the training heartbeat ``progress_enabled``/
  ``report_progress`` with its echo of the supervisor's clock probe, the
  serve-plane load beat ``report_serve``, and the async checkpoint's
  ``report_checkpoint_committed``), in the same record format, so a port job
  reports to the unchanged supervisor. Two fault sites come with it:
  ``stall_rendezvous`` (:func:`fault_stall_if_armed`, the first thing
  :func:`initialize_from_env` does) and ``drop_heartbeat`` (in
  :func:`report_progress`).
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
from dataclasses import dataclass, field, replace
from datetime import timedelta
from pathlib import Path
from typing import Any, Optional

from .. import faults, obs
from ..backoff import Backoff, retry_call


@dataclass
class WorldInfo:
    num_processes: int
    process_id: int
    coordinator: str
    replica_type: str
    replica_index: int
    restart_count: int
    job_key: str
    # Elastic resize epoch: a resize record with a newer generation in the
    # status dir means the world moved on (poll_resize).
    resize_generation: int = 0
    # Set by a multi-process join: the process group's backend, the rank's
    # device, and the c10d store that finalize's barrier runs over.
    backend: str = ""
    device: str = ""
    store: Any = field(default=None, repr=False, compare=False)

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


def join_backoff(timeout_s: float, base_s: float, seed: int) -> Backoff:
    """The rendezvous retry schedule: exponential with deterministic jitter
    (seeded by process id, so a gang's workers do not herd on the
    coordinator), capped well inside the join timeout."""
    return Backoff(
        base_s=base_s,
        cap_s=max(base_s, min(10.0, timeout_s / 4.0)),
        jitter=0.25,
        seed=seed,
    )


# ---- elastic resize (the JAX package's controller/elastic.py is the writer) ----


@dataclass
class ResizeSignal:
    """One observed resize-record advance: this process's place in the new
    world, or its eviction from it."""

    generation: int
    evicted: bool
    world: Optional[WorldInfo]  # None when evicted
    restore_step: Optional[int]  # last sidecar-verified step at resize time
    record: dict


def _member_id(world: WorldInfo) -> str:
    return f"{world.replica_type.lower()}-{world.replica_index}"


def read_resize_record() -> Optional[dict]:
    d = os.environ.get("TPUJOB_STATUS_DIR")
    if not d:
        return None
    try:
        with open(Path(d) / "resize.json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def poll_resize(world: WorldInfo) -> Optional[ResizeSignal]:
    """Step-loop resize check: has the supervisor advanced the world past
    this process's generation? None while the world is current; else the
    new membership, or the eviction fence for a process absent from the
    record's rank map (it has no place in the new world and must exit)."""
    rec = read_resize_record()
    if rec is None:
        return None
    try:
        gen = int(rec.get("generation", 0))
    except (TypeError, ValueError):
        return None
    if gen <= world.resize_generation:
        return None
    ranks = rec.get("ranks") or {}
    restore = rec.get("restore_step")
    restore = int(restore) if restore is not None else None
    rank = ranks.get(_member_id(world))
    if rank is None:
        return ResizeSignal(gen, True, None, restore, rec)
    new_world = replace(
        world,
        num_processes=int(rec.get("world_size", len(ranks))),
        process_id=int(rank),
        coordinator=str(rec.get("coordinator", world.coordinator)),
        resize_generation=gen,
    )
    return ResizeSignal(gen, False, new_world, restore, rec)


# How long a rank whose collective lost a peer waits for the supervisor's
# resize record before it fails (a death the gang cannot absorb has none).
PEER_LOST_WAIT_S = 60.0


def peer_lost(err: BaseException) -> bool:
    """Whether ``err`` is a collective that failed because a peer process
    went away (gloo's closed or reset connection, c10d's network errors):
    the survivors of a preempted peer see this before the supervisor has
    committed a resize."""
    import torch.distributed as dist

    msg = str(err)
    return isinstance(err, getattr(dist, "DistNetworkError", ())) or (
        isinstance(err, RuntimeError)
        and ("Connection closed by peer" in msg or "Connection reset by peer" in msg)
    )


def await_resize(world: WorldInfo, timeout_s: float = PEER_LOST_WAIT_S,
                 interval_s: float = 0.2) -> Optional[ResizeSignal]:
    """:func:`poll_resize` until the supervisor's resize record for a newer
    generation appears or ``timeout_s`` passes (then None)."""
    deadline = time.monotonic() + timeout_s
    while True:
        sig = poll_resize(world)
        if sig is not None or time.monotonic() >= deadline:
            return sig
        time.sleep(interval_s)


def adopt_resize(sig: ResizeSignal) -> WorldInfo:
    """Become a member of the resized world and report the re-join."""
    report(
        "resize_join",
        generation=sig.generation,
        rank=sig.world.process_id,
        world_size=sig.world.num_processes,
    )
    return sig.world


def exit_for_resize(sig: ResizeSignal) -> None:
    """Terminal resize outcomes. Evicted: report and exit 0. A member:
    re-exec in place (same pid, same log) with the ``TPUJOB_*`` and c10d
    variables rewritten to the new generation's coordinates; the fresh
    ``main()`` joins at the new coordinator and restores from the last
    verified checkpoint."""
    if sig.evicted:
        report("resize_evicted", generation=sig.generation)
        print(
            f"[rendezvous] evicted by resize generation {sig.generation}; exiting.",
            flush=True,
        )
        sys.stdout.flush()
        sys.stderr.flush()
        raise SystemExit(0)
    w = sig.world
    host, _, port = w.coordinator.rpartition(":")
    os.environ.update(
        {
            "TPUJOB_NUM_PROCESSES": str(w.num_processes),
            "TPUJOB_PROCESS_ID": str(w.process_id),
            "TPUJOB_COORDINATOR_ADDRESS": w.coordinator,
            "TPUJOB_RESIZE_GENERATION": str(w.resize_generation),
            "WORLD_SIZE": str(w.num_processes),
            "RANK": str(w.process_id),
            "MASTER_ADDR": host or "127.0.0.1",
            "MASTER_PORT": port,
            "TPU_WORKER_ID": str(w.process_id),
            "TPU_WORKER_HOSTNAMES": ",".join([host or "127.0.0.1"] * w.num_processes),
        }
    )
    report(
        "resize_join",
        generation=sig.generation,
        rank=w.process_id,
        world_size=w.num_processes,
        via="exec",
    )
    print(
        f"[rendezvous] re-joining resized world: generation {sig.generation}, rank "
        f"{w.process_id}/{w.num_processes} at {w.coordinator} (in-place exec)",
        flush=True,
    )
    sys.stdout.flush()
    sys.stderr.flush()
    argv = getattr(sys, "orig_argv", None)
    if argv and len(argv) > 1:
        os.execv(sys.executable, [sys.executable] + list(argv[1:]))
    os.execv(sys.executable, [sys.executable] + sys.argv)


# ---- joining a multi-process world ----


def _device_id(dev) -> list:
    """What two ranks compare to learn whether they share a device: (host,
    device type, GPU UUID)."""
    import torch

    uuid = ""
    if dev.type == "cuda":
        uuid = str(torch.cuda.get_device_properties(dev).uuid)
    return [socket.gethostname(), dev.type, uuid]


def choose_backend(device_ids) -> tuple:
    """``(backend, reason)`` from every rank's :func:`_device_id`, the same
    on every rank: gloo when any rank is on the CPU, gloo when two ranks
    share a GPU (NCCL refuses a communicator with two ranks on one GPU),
    nccl when every rank has a GPU of its own."""
    ids = [tuple(d) for d in device_ids]
    if any(d[1] != "cuda" for d in ids):
        return "gloo", "a rank runs on the CPU"
    if len(set(ids)) < len(ids):
        return "gloo", "ranks share a GPU"
    return "nccl", "every rank has a GPU of its own"


def _join(world: WorldInfo, dev, timeout_s: float, retry_interval_s: float):
    """The store at the coordinator (connection retried on the join
    schedule), the exchange of device ids through it, then the process
    group on the chosen backend. Returns ``(store, backend, reason)``."""
    import torch.distributed as dist

    host, _, port = world.coordinator.rpartition(":")
    timeout = timedelta(seconds=timeout_s)

    def connect():
        return dist.TCPStore(
            host or "127.0.0.1", int(port), world.num_processes,
            is_master=world.process_id == 0, timeout=timeout, wait_for_workers=False,
        )

    store = retry_call(
        connect,
        backoff=join_backoff(timeout_s, retry_interval_s, world.process_id),
        timeout_s=timeout_s,
    )
    gen = world.resize_generation
    store.set(f"tpujob/{gen}/device/{world.process_id}", json.dumps(_device_id(dev)))
    ids = [
        json.loads(store.get(f"tpujob/{gen}/device/{r}"))
        for r in range(world.num_processes)
    ]
    backend, reason = choose_backend(ids)
    dist.init_process_group(
        backend,
        store=dist.PrefixStore(f"tpujob/{gen}/pg", store),
        rank=world.process_id,
        world_size=world.num_processes,
        timeout=timeout,
    )
    return store, backend, reason


def fenced_world_from_env() -> WorldInfo:
    """The world the environment describes, after the ``stall_rendezvous``
    fault site and the resize fence (an environment older than the status
    dir's resize record adopts its new coordinates; one absent from the new
    member map exits). It joins nothing: :func:`initialize_from_env` joins
    it, and a process that needs no process group (a serve replica) takes it
    as it is."""
    fault_stall_if_armed()
    world = world_from_env()
    sig = poll_resize(world)
    if sig is not None:
        if sig.evicted:
            exit_for_resize(sig)
        world = adopt_resize(sig)
    return world


def initialize_from_env(
    timeout_s: float = 60.0, retry_interval_s: float = 1.0, device=None
) -> WorldInfo:
    """Join the world :func:`fenced_world_from_env` describes (the
    ``stall_rendezvous`` fault site and the resize fence come first).

    A single-process world needs no process group and returns at once. A
    multi-process world joins at the coordinator with explicit arguments
    (never ``env://``: a resize rewrites the world): the rank's device is
    :func:`~pytorch_operator_tpu_torch.runtime.device.rank_device` (``device``
    as there; on CUDA it becomes the current device), the backend
    :func:`choose_backend`'s. A world that cannot form within ``timeout_s``
    raises ``TimeoutError``; a failed gloo or NCCL init raises too. Nothing
    falls back to a world of one process."""
    t_join = time.time()
    world = fenced_world_from_env()
    if world.num_processes <= 1:
        return world

    import torch

    from .device import rank_device

    dev = rank_device(world.process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        with obs.span(
            "rendezvous_join", cat="rendezvous",
            coordinator=world.coordinator, world=world.num_processes,
        ):
            store, backend, reason = _join(world, dev, timeout_s, retry_interval_s)
    except Exception as e:
        raise TimeoutError(
            f"rendezvous with coordinator {world.coordinator} failed within "
            f"{timeout_s}s: {e}"
        ) from e
    world = replace(world, backend=backend, device=str(dev), store=store)
    report(
        "rendezvous_join", seconds=time.time() - t_join, backend=backend, device=str(dev),
        world=world.num_processes,
    )
    print(
        f"[rendezvous] rank {world.process_id}/{world.num_processes} joined at "
        f"{world.coordinator}: backend {backend} ({reason}), device {dev}",
        flush=True,
    )
    return world


def finalize(world: WorldInfo, exit_code: int = 0) -> None:
    """Leave a multi-process world deterministically once the workload is
    done: a barrier over the c10d store (key-value traffic, not a
    collective), the leader's grace period (it hosts the store, and its
    peers' exits must not find it gone), ``destroy_process_group``, then
    ``os._exit(exit_code)``, so that no gloo or NCCL thread races the
    interpreter's teardown of a replica that finished its work (a crash
    there is a retryable exit that would re-run a finished life).
    Single-process worlds return normally. A barrier failure is swallowed:
    it means a peer died, which is the supervisor's business; this
    replica's exit code must still say that its work is done."""
    if world.num_processes <= 1:
        return
    sys.stdout.flush()
    sys.stderr.flush()
    try:
        store = world.store
        if store is not None:
            gen = world.resize_generation
            try:
                store.set(f"tpujob/{gen}/finalize/{world.process_id}", "1")
                store.wait(
                    [f"tpujob/{gen}/finalize/{r}" for r in range(world.num_processes)],
                    timedelta(seconds=10),
                )
            except Exception:
                # invariant: waived — the finalize barrier is best-effort; peers may already be gone
                pass
            if world.process_id == 0:
                time.sleep(1.0)
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:
        # invariant: waived — nothing may stop the exit code from reaching the supervisor via os._exit
        pass
    os._exit(exit_code)


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
