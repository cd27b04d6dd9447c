"""Preemption and the worker-side fault sites of the port
(pytorch_operator_tpu_torch/workloads/llama_train.py ``--preempt-at``,
runtime/rendezvous.py, faults.py, obs/trace.py), on the CPU.

- ``llama_train.main(["--preempt-at", ...])`` exits 138 through ``os._exit``
  on a replica's first life (``TPUJOB_RESTART_COUNT`` 0) and runs through on
  a later one; ``--preempt-index`` picks the replicas by
  ``TPUJOB_REPLICA_INDEX``, as in the JAX workload.
- Under the unchanged supervisor, a port job with ``RestartPolicy.EXIT_CODE``
  and ``--checkpoint-every 2 --preempt-at 3`` restarts once and resumes from
  a verified step, as the JAX job does (tests/test_elastic_e2e.py).
- ``drop_heartbeat`` drops the nth ``progress`` record; ``stall_rendezvous``
  sleeps at the join and writes a ``fault_stall`` record; the port's
  ``obs.span`` records load with the JAX package's span loader.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from pytorch_operator_tpu_torch import faults as port_faults
from pytorch_operator_tpu_torch.workloads import llama_train

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--batch-size", "4", "--seq-len", "16", "--warmup", "1"]


def _run_main(args, env_over, tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUJOB_")}
    env.update(env_over, PYTHONPATH=str(ROOT))
    code = "import sys; from pytorch_operator_tpu_torch.workloads import llama_train; " \
           "sys.exit(llama_train.main(sys.argv[1:]))"
    return subprocess.run(
        [sys.executable, "-c", code, *TINY, *args], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("restart,code", [("0", 138), ("1", 0)])
def test_preempt_at_exits_138_on_the_first_life_only(tmp_path, restart, code):
    out = _run_main(["--steps", "6", "--preempt-at", "3", "--json"],
                    {"TPUJOB_RESTART_COUNT": restart}, tmp_path)
    assert out.returncode == code, out.stderr[-2000:]
    if code == 138:
        assert "injected preemption at step 3 (exit 138)" in out.stdout
        assert '"metric"' not in out.stdout  # nothing after the exit ran
    else:
        assert json.loads(out.stdout.strip().splitlines()[-1])["end_step"] == 7


def test_preempt_index_picks_the_replicas(tmp_path):
    out = _run_main(["--steps", "4", "--preempt-at", "2", "--preempt-index", "0,2"],
                    {"TPUJOB_REPLICA_INDEX": "1"}, tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    out = _run_main(["--steps", "4", "--preempt-at", "2", "--preempt-index", "1"],
                    {"TPUJOB_REPLICA_INDEX": "1"}, tmp_path)
    assert out.returncode == 138 and "injected preemption" in out.stdout


@pytest.mark.parametrize(
    "index,chosen,expected",
    [(None, None, 5), ("0", None, 5), ("3", "1,3", 5), ("2", "1,3", None), ("0", " 0 ,", 5)],
)
def test_preempt_index_parses_as_in_jax(monkeypatch, index, chosen, expected):
    if index is None:
        monkeypatch.delenv("TPUJOB_REPLICA_INDEX", raising=False)
    else:
        monkeypatch.setenv("TPUJOB_REPLICA_INDEX", index)
    args = SimpleNamespace(preempt_at=5, preempt_index=chosen)
    assert llama_train._preempt_at(args) == expected


def test_preempted_port_job_resumes_under_the_supervisor(tmp_path):
    """The unchanged supervisor restarts a port job that exits 138 under
    ``RestartPolicy.EXIT_CODE``; the second life resumes from the step-2
    checkpoint (the save at 2 was blocking and verified before step 3
    preempted) and finishes."""
    from pytorch_operator_tpu.api import ProcessTemplate, ReplicaType, Resources
    from pytorch_operator_tpu.api.types import RestartPolicy
    from pytorch_operator_tpu.controller import Supervisor
    from tests.testutil import new_job

    sup = Supervisor(state_dir=tmp_path / "state", poll_interval=0.05)
    job = new_job(name="preempt-torch", workers=0, restart_policy=RestartPolicy.EXIT_CODE,
                  backoff_limit=3)
    job.spec.port = None
    job.spec.replica_specs[ReplicaType.MASTER].template = ProcessTemplate(
        module="pytorch_operator_tpu_torch.workloads.llama_train",
        args=["--config", "tiny", "--batch-size", "4", "--seq-len", "16", "--steps", "6",
              "--warmup", "1", "--checkpoint-every", "2", "--preempt-at", "3"],
        resources=Resources(cpu_devices=1),
    )
    try:
        done = sup.run(job, timeout=240)
        text = "\n".join(p.read_text() for p in sorted((tmp_path / "state" / "logs").glob("*preempt-torch*")))
        assert done.is_succeeded(), text[-3000:]
        assert done.status.restart_count == 1
        assert "injected preemption at step 3" in text
        resumed = [ln for ln in text.splitlines() if "resumed from checkpoint" in ln]
        assert resumed and all(int(ln.rsplit("step", 1)[1]) >= 2 for ln in resumed), resumed
    finally:
        sup.shutdown()


@pytest.fixture
def replica(monkeypatch, tmp_path):
    """A replica's env with a status dir; ``arm(*faults)`` threads a plan."""
    monkeypatch.setenv("TPUJOB_STATUS_DIR", str(tmp_path))
    monkeypatch.setenv("TPUJOB_REPLICA_TYPE", "Worker")
    monkeypatch.setenv("TPUJOB_REPLICA_INDEX", "0")
    monkeypatch.setenv("TPUJOB_RESTART_COUNT", "0")
    monkeypatch.setenv("TPUJOB_NUM_PROCESSES", "1")

    def arm(*faults):
        monkeypatch.setenv("TPUJOB_FAULT_PLAN", json.dumps({"faults": list(faults)}))
        port_faults.reset()

    def records():
        return [json.loads(x) for x in (tmp_path / "worker-0.jsonl").read_text().splitlines()]

    yield SimpleNamespace(arm=arm, records=records)
    port_faults.reset()


def test_drop_heartbeat_drops_the_nth_progress_record(replica):
    from pytorch_operator_tpu_torch.runtime import rendezvous

    replica.arm({"kind": "drop_heartbeat", "target": "worker-0", "nth": 2, "times": 2})
    for step in range(1, 6):
        rendezvous.report_progress(step, loss=1.0)
    assert [r["step"] for r in replica.records() if r["event"] == "progress"] == [1, 4, 5]


def test_drop_heartbeat_honours_target_and_restart(replica):
    from pytorch_operator_tpu_torch.runtime import rendezvous

    replica.arm({"kind": "drop_heartbeat", "target": "worker-1", "nth": 1},
                {"kind": "drop_heartbeat", "nth": 1, "restart": 1})
    rendezvous.report_progress(1)
    assert [r["step"] for r in replica.records() if r["event"] == "progress"] == [1]


def test_stall_rendezvous_sleeps_and_writes_a_fault_stall_record(replica):
    from pytorch_operator_tpu_torch.runtime import rendezvous

    replica.arm({"kind": "stall_rendezvous", "seconds": 0.05})
    assert rendezvous.initialize_from_env().replica_index == 0
    rendezvous.initialize_from_env()  # fired once: no second stall
    recs = [r for r in replica.records() if r["event"] == "fault_stall"]
    assert recs == [{**recs[0], "seconds": 0.05, "site": "rendezvous"}] and len(recs) == 1


def test_port_spans_load_with_the_jax_span_loader(monkeypatch, tmp_path):
    from pytorch_operator_tpu.obs.trace import load_span_file
    from pytorch_operator_tpu_torch import obs
    from pytorch_operator_tpu_torch.obs import trace

    monkeypatch.setenv("TPUJOB_TRACE_DIR", str(tmp_path))
    trace.reset_tracer()
    try:
        with obs.span("step", cat="step", step=3):
            pass
        with pytest.raises(ValueError):
            with obs.span("ckpt_commit", cat="ckpt", step=4):
                raise ValueError("recorded all the same")
        path = obs.tracer().path
    finally:
        trace.reset_tracer()
    spans = [e for e in load_span_file(path) if e.get("ph") == "X"]
    assert [(e["name"], e["cat"], e["args"]) for e in spans] == [
        ("step", "step", {"step": 3}), ("ckpt_commit", "ckpt", {"step": 4}),
    ]
    assert all(e["dur"] >= 0 for e in spans)
    monkeypatch.delenv("TPUJOB_TRACE_DIR")
    trace.reset_tracer()
    assert obs.span("step") is obs.span("save")  # disabled: the shared nullcontext
