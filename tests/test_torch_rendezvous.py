"""The port's multi-process rendezvous (runtime/rendezvous.py) and the
distributed canary (workloads/smoke_dist.py), on the CPU.

- The resize fence (``poll_resize``, ``adopt_resize``, ``exit_for_resize``)
  agrees with the JAX package's on the same ``resize.json``: the signal, the
  status records, the rewritten environment of the re-exec.
- ``join_backoff`` sleeps JAX's schedule; the backend rule.
- Two processes given the supervisor's env join over gloo on the CPU, the
  ``rendezvous_join`` record carries backend and device, and ``finalize``
  exits with the code it is given; a world whose peer never comes raises.
- Port ``smoke_dist`` and a port ``llama_train --mesh fsdp=2`` job run as
  Master + 1 Worker under the unchanged supervisor and succeed.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from pytorch_operator_tpu.runtime import rendezvous as jax_rdzv
from pytorch_operator_tpu_torch.runtime import rendezvous
from tests import torch_worlds

ROOT = Path(__file__).resolve().parents[1]
JAX_FIELDS = [f.name for f in dataclasses.fields(jax_rdzv.WorldInfo)]


def _worlds(**over):
    base = dict(num_processes=3, process_id=1, coordinator="127.0.0.1:5000",
                replica_type="Worker", replica_index=0, restart_count=0,
                job_key="default/j", resize_generation=2)
    base.update(over)
    return jax_rdzv.WorldInfo(**base), rendezvous.WorldInfo(**base)


def _as_jax(world):
    return None if world is None else {k: getattr(world, k) for k in JAX_FIELDS}


RECORDS = {
    "newer, member": {"generation": 3, "ranks": {"worker-0": 0, "master-0": 1},
                      "world_size": 2, "coordinator": "127.0.0.1:6001", "restore_step": 8},
    "newer, evicted": {"generation": 4, "ranks": {"master-0": 0}, "world_size": 1},
    "same generation": {"generation": 2, "ranks": {"worker-0": 0}},
    "older generation": {"generation": 1, "ranks": {"worker-0": 0}},
    "bad generation": {"generation": "x", "ranks": {"worker-0": 0}},
    "no restore step, no size": {"generation": 5, "ranks": {"worker-0": 1, "master-0": 0}},
}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_poll_resize_matches_jax(name, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUJOB_STATUS_DIR", str(tmp_path))
    (tmp_path / "resize.json").write_text(json.dumps(RECORDS[name]))
    jw, pw = _worlds()
    assert rendezvous.read_resize_record() == jax_rdzv.read_resize_record()
    want, got = jax_rdzv.poll_resize(jw), rendezvous.poll_resize(pw)
    assert (want is None) == (got is None)
    if want is not None:
        assert (got.generation, got.evicted, got.restore_step, got.record) == (
            want.generation, want.evicted, want.restore_step, want.record)
        assert _as_jax(got.world) == _as_jax(want.world)


def test_no_status_dir_no_signal(monkeypatch):
    monkeypatch.delenv("TPUJOB_STATUS_DIR", raising=False)
    jw, pw = _worlds()
    assert rendezvous.poll_resize(pw) is None and jax_rdzv.poll_resize(jw) is None


def _records(path: Path):
    return [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in path.read_text().splitlines()]


def test_adopt_and_exit_for_resize_match_jax(tmp_path, monkeypatch):
    """The same records, the same eviction exit, and the same environment
    handed to the re-exec (os.execv intercepted) as JAX's."""
    (tmp_path / "resize.json").write_text(json.dumps(RECORDS["newer, member"]))
    out = {}
    for side, mod in (("jax", jax_rdzv), ("port", rendezvous)):
        status = tmp_path / side
        status.mkdir()
        monkeypatch.setenv("TPUJOB_STATUS_DIR", str(status))
        (status / "resize.json").write_text((tmp_path / "resize.json").read_text())
        monkeypatch.setenv("TPUJOB_REPLICA_TYPE", "Worker")
        sig = mod.poll_resize(_worlds()[0 if side == "jax" else 1])
        mod.adopt_resize(sig)
        calls = []
        monkeypatch.setattr(os, "execv", lambda exe, argv: calls.append(argv))
        saved = dict(os.environ)
        try:
            mod.exit_for_resize(sig)
            env = {k: os.environ.get(k) for k in (
                "TPUJOB_NUM_PROCESSES", "TPUJOB_PROCESS_ID", "TPUJOB_COORDINATOR_ADDRESS",
                "TPUJOB_RESIZE_GENERATION", "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                "TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES")}
        finally:
            os.environ.clear()
            os.environ.update(saved)
        evicted = dataclasses.replace(sig, evicted=True, world=None)
        with pytest.raises(SystemExit) as exit_info:
            mod.exit_for_resize(evicted)
        out[side] = (env, len(calls), exit_info.value.code, _records(status / "worker-0.jsonl"))
    assert out["port"] == out["jax"]
    assert out["port"][0]["TPUJOB_PROCESS_ID"] == "0" and out["port"][2] == 0


def test_join_backoff_matches_jax():
    for args in ((60.0, 1.0, 0), (60.0, 1.0, 3), (8.0, 0.5, 1)):
        assert rendezvous.join_backoff(*args).delays(8) == jax_rdzv.join_backoff(*args).delays(8)


@pytest.mark.parametrize(
    "ids,backend",
    [
        ([["h", "cpu", ""], ["h", "cpu", ""]], "gloo"),
        ([["h", "cuda", "u0"], ["h", "cuda", "u0"]], "gloo"),
        ([["h", "cuda", "u0"], ["h", "cuda", "u1"]], "nccl"),
        ([["a", "cuda", "u0"], ["b", "cuda", "u0"]], "nccl"),
        ([["h", "cuda", "u0"], ["h", "cpu", ""]], "gloo"),
    ],
    ids=["cpu", "shared-gpu", "own-gpus", "two-hosts", "mixed"],
)
def test_backend_rule(ids, backend):
    assert rendezvous.choose_backend(ids)[0] == backend


def test_single_process_world_needs_no_group(monkeypatch):
    for k in ("TPUJOB_NUM_PROCESSES", "TPUJOB_STATUS_DIR"):
        monkeypatch.delenv(k, raising=False)
    world = rendezvous.initialize_from_env()
    assert world.num_processes == 1 and world.backend == ""
    rendezvous.finalize(world, 3)  # returns: nothing to leave


_JOIN_AND_FINALIZE = """
import sys
from pytorch_operator_tpu_torch.runtime import rendezvous
world = rendezvous.initialize_from_env(timeout_s=60)
print("joined", world.backend, world.device, flush=True)
rendezvous.finalize(world, int(sys.argv[1]) + world.process_id)
"""


def test_two_processes_join_report_and_finalize_with_the_code(tmp_path):
    port = torch_worlds.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, **torch_worlds.world_env(rank, 2, port, TPUJOB_STATUS_DIR=str(tmp_path)))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _JOIN_AND_FINALIZE, "7"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [7, 8], outs
    assert all("joined gloo cpu" in o for o, _ in outs)
    for name in ("master-0.jsonl", "worker-0.jsonl"):
        joins = [r for r in _records(tmp_path / name) if r["event"] == "rendezvous_join"]
        assert len(joins) == 1
        assert (joins[0]["backend"], joins[0]["device"], joins[0]["world"]) == ("gloo", "cpu", 2)


def test_a_world_that_cannot_form_raises(monkeypatch):
    """Rank 0 of a world of two whose peer never comes: TimeoutError, never
    a world of one."""
    monkeypatch.delenv("TPUJOB_STATUS_DIR", raising=False)
    for k, v in torch_worlds.world_env(0, 2, torch_worlds.free_port()).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(TimeoutError, match="rendezvous with coordinator"):
        rendezvous.initialize_from_env(timeout_s=2, retry_interval_s=0.2)
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_smoke_dist_checks_in_a_world_of_one():
    import torch

    world = rendezvous.world_from_env()
    from pytorch_operator_tpu_torch.workloads import smoke_dist

    assert smoke_dist.checks(dataclasses.replace(world, num_processes=1, process_id=0),
                             torch.device("cpu")) == []


def _supervised(tmp_path, name, module, args=()):
    from pytorch_operator_tpu.api import ProcessTemplate, Resources
    from pytorch_operator_tpu.controller import Supervisor
    from tests.testutil import new_job

    sup = Supervisor(state_dir=tmp_path / "state", poll_interval=0.1)
    job = new_job(name=name, workers=1)
    job.spec.port = None  # auto-allocate: no TIME_WAIT across runs
    for rs in job.spec.replica_specs.values():
        rs.template = ProcessTemplate(module=module, args=list(args),
                                      resources=Resources(cpu_devices=1))
    try:
        done = sup.run(job, timeout=240)
    finally:
        sup.shutdown()
    logs = {who: (tmp_path / "state" / "logs" / f"default_{name}-{who}-0.log").read_text()
            for who in ("master", "worker")}
    return done, logs


def test_port_smoke_dist_under_the_supervisor(tmp_path):
    done, logs = _supervised(tmp_path, "smoke-dist-torch", "pytorch_operator_tpu_torch.workloads.smoke_dist")
    assert done.is_succeeded(), logs
    assert "rank 0: OK" in logs["master"] and "rank 1: OK" in logs["worker"]
    assert "backend gloo, device cpu" in logs["master"]


def test_port_fsdp_training_job_under_the_supervisor(tmp_path):
    done, logs = _supervised(
        tmp_path, "llama-fsdp-torch", "pytorch_operator_tpu_torch.workloads.llama_train",
        ["--config", "tiny", "--mesh", "fsdp=2", "--batch-size", "4", "--seq-len", "16",
         "--steps", "2", "--warmup", "1", "--grad-clip", "1.0", "--json"],
    )
    assert done.is_succeeded(), logs
    result = json.loads(logs["master"].strip().splitlines()[-1])
    assert result["world"] == 2 and result["mesh"] == {"fsdp": 2} and result["backend"] == "gloo"
    assert [r["rank"] for r in result["per_rank"]] == [0, 1]
    assert "[rank 1/2]" in logs["worker"] and '"metric"' not in logs["worker"]
