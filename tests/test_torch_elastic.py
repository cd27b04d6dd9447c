"""Elastic recovery with the port's ``llama_train``
(``pytorch_operator_tpu_torch.workloads.llama_train``) under the JAX
package's supervisor: the port's copies of ``tests/test_elastic_e2e.py``'s
scenarios (BASELINE.json:11, the elastic job) and of
``examples/elastic.yaml``'s in-place resize.

- A Worker preempts itself (exit 138) at step 12 of its first life; the
  supervisor gang-restarts the world once, and the restarted gang resumes
  from a checkpoint at step >= 3 (tier-1).
- ``slow``, as the JAX file's are: a preempted fsdp=4 world resubmitted to
  a supervisor with two slots comes back as fsdp=2 and resumes from the
  fsdp=4 step (shrink); a job launched shrunk grows back to fsdp=4 when a
  squatter frees its slots and resumes across both transitions (grow
  back); ``examples/elastic-torch.yaml`` resizes 4 ranks to 2 in place.
"""

import pathlib

import pytest

from pytorch_operator_tpu.api import (
    ElasticPolicy,
    ProcessTemplate,
    ReplicaSpec,
    ReplicaType,
    Resources,
    RestartPolicy,
)
from pytorch_operator_tpu.controller import Supervisor
from tests.testutil import new_job

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULE = "pytorch_operator_tpu_torch.workloads.llama_train"


def _llama_args(max_steps):
    return [
        "--config", "tiny", "--seq-len", "32", "--batch-size", "4",
        "--steps", "500", "--max-steps", str(max_steps),
        "--checkpoint-every", "3", "--warmup", "1",
    ]


def _template(args, extra=()):
    return ProcessTemplate(module=MODULE, args=list(args) + list(extra), resources=Resources(cpu_devices=1))


def _elastic_job(name, workers, args, worker_extra=(), backoff=4):
    job = new_job(
        name=name, workers=workers, restart_policy=RestartPolicy.EXIT_CODE, backoff_limit=backoff,
        elastic=ElasticPolicy(min_replicas=1, max_replicas=max(workers, 1), max_restarts=4),
    )
    job.spec.port = None
    job.spec.replica_specs[ReplicaType.MASTER].template = _template(args)
    job.spec.replica_specs[ReplicaType.WORKER] = ReplicaSpec(
        replicas=workers, restart_policy=RestartPolicy.EXIT_CODE,
        template=_template(args, worker_extra),
    )
    return job


def _log_text(state, pattern):
    return "\n".join(p.read_text() for p in sorted((state / "logs").glob(pattern)))


def _resumed_steps(text):
    resumed = [ln for ln in text.splitlines() if "resumed from checkpoint" in ln]
    assert resumed, text[-2000:]
    return [int(ln.rsplit("step", 1)[1]) for ln in resumed]


def test_preemption_gang_restart_resumes_from_checkpoint(tmp_path):
    state = tmp_path / "state"
    sup = Supervisor(state_dir=state, poll_interval=0.05)
    # The Worker preempts itself at step 12 of its FIRST life: checkpoints
    # exist at steps 3..12 by then, so the restarted gang resumes from one.
    job = _elastic_job("elastic-torch-e2e", 1, _llama_args(30), ["--preempt-at", "12"])
    try:
        done = sup.run(job, timeout=420)
        assert done.is_succeeded(), [c.to_dict() for c in done.status.conditions]
        assert done.status.restart_count == 1
        text = _log_text(state, "*elastic-torch-e2e*")
        assert "injected preemption at step" in text
        assert "'fsdp': 2" in text, text[-2000:]
        assert all(s >= 3 for s in _resumed_steps(text))
    finally:
        sup.shutdown()


@pytest.mark.slow
def test_shrink_resume_reshards_checkpoint_across_world_sizes(tmp_path):
    """Life 1: master + 3 workers (fsdp=4), every worker preempts at step
    8, no restart budget: the job fails with checkpoints at 3 and 6. Life
    2: the same job on a supervisor with two slots launches master + 1
    worker (ElasticScaledDown), and the fsdp=2 world resumes from the
    fsdp=4 step."""
    from pytorch_operator_tpu.controller.store import job_key

    state = tmp_path / "state"
    args = _llama_args(16)
    sup1 = Supervisor(state_dir=state, poll_interval=0.05, max_slots=4)
    try:
        done1 = sup1.run(_elastic_job("shrink-torch", 3, args, ["--preempt-at", "8"], backoff=0), timeout=420)
        assert not done1.is_succeeded()
        assert "'fsdp': 4" in _log_text(state, "*shrink-torch-master*")
        assert any((state / "checkpoints" / "default_shrink-torch").iterdir())
        sup1.delete_job(job_key(done1))  # no purge: the checkpoints survive
    finally:
        sup1.shutdown()
    sup2 = Supervisor(state_dir=state, poll_interval=0.05, max_slots=2)
    try:
        done2 = sup2.run(_elastic_job("shrink-torch", 3, args, backoff=0), timeout=420)
        assert done2.is_succeeded(), [c.to_dict() for c in done2.status.conditions]
        assert any(e.reason == "ElasticScaledDown" for e in sup2.events.for_job(job_key(done2)))
        text = _log_text(state, "*shrink-torch-master*")
        assert "'fsdp': 2" in text, text[-2000:]
        assert all(s >= 3 for s in _resumed_steps(text))
    finally:
        sup2.shutdown()


@pytest.mark.slow
def test_grow_back_resumes_when_capacity_frees(tmp_path):
    """A squatter holds two of four slots until the elastic job's first
    checkpoint lands; the job launches shrunk (fsdp=2), grows back to
    fsdp=4 when the squatter exits (one restart), and resumes from a
    checkpoint across both transitions."""
    import threading
    import time

    state = tmp_path / "state"
    sup = Supervisor(state_dir=state, poll_interval=0.05, max_slots=4)
    try:
        squatter = new_job(name="squatter", workers=0)
        squatter.spec.port = None
        squatter.spec.replica_specs[ReplicaType.MASTER].template = ProcessTemplate(
            module="tests.standby_probe",
            env={"PROBE_WAIT_FOR_GLOB": str(state / "checkpoints" / "default_grow-torch" / "*" / "meta.json")},
            resources=Resources(cpu_devices=2),
        )
        squat_key = sup.submit(squatter)
        stop = threading.Event()

        def pump():
            while not stop.is_set():
                try:
                    sup.reconciler.sync(squat_key)
                except Exception:
                    return
                time.sleep(0.05)

        pump_t = threading.Thread(target=pump, daemon=True)
        pump_t.start()
        deadline = time.time() + 60
        while sum(e.reason == "SuccessfulCreateReplica" for e in sup.events.for_job(squat_key)) < 1:
            assert time.time() < deadline, "squatter never launched"
            time.sleep(0.05)
        key = sup.submit(_elastic_job("grow-torch", 3, _llama_args(16)))
        done = sup.wait(key, timeout=420)
        assert done.is_succeeded(), [c.to_dict() for c in done.status.conditions]
        assert sup.wait(squat_key, timeout=60).is_succeeded()
        stop.set()
        pump_t.join(timeout=10)
        reasons = [e.reason for e in sup.events.for_job(key)]
        assert "ElasticScaledDown" in reasons and "ElasticScaledUp" in reasons, reasons
        assert done.status.restart_count == 1
        text = _log_text(state, "*grow-torch-master*")
        assert "'fsdp': 2" in text and "'fsdp': 4" in text, text[-2000:]
        assert all(s >= 3 for s in _resumed_steps(text))
    finally:
        sup.shutdown()


@pytest.mark.slow
def test_example_elastic_resizes_in_place(tmp_path):
    """``examples/elastic-torch.yaml`` as written: two of three workers
    preempt at step 12; the survivors re-rank in place (ElasticScaledDown,
    no gang restart), the fsdp=2 world resumes from the fsdp=4 checkpoint
    and the job succeeds."""
    from pytorch_operator_tpu.api import load_job
    from pytorch_operator_tpu.controller.store import job_key

    job = load_job(ROOT / "examples" / "elastic-torch.yaml")
    job.spec.port = None
    state = tmp_path / "state"
    sup = Supervisor(state_dir=state, poll_interval=0.05)
    try:
        done = sup.run(job, timeout=600)
        assert done.is_succeeded(), [c.to_dict() for c in done.status.conditions]
        assert any(e.reason == "ElasticScaledDown" for e in sup.events.for_job(job_key(done)))
        text = _log_text(state, "*elastic-torch-master*")
        assert "'fsdp': 4" in text and "'fsdp': 2" in text, text[-2000:]
        assert all(s >= 3 for s in _resumed_steps(text))
    finally:
        sup.shutdown()
