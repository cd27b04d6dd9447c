"""The port's twins of the last JAX examples without one, each as written
under the unchanged supervisor, on the CPU:

- ``examples/generate-torch.yaml``: generate at the 0.3b config's width,
  with the JAX example's args (the test cuts the depth and the length);
- ``examples/dataplane-torch.yaml``: ``llama_train`` under ``data_plane:``
  (async checkpoints, prefetch, autotune, two producer threads);
- ``examples/serve-fleet-torch.yaml``: a Master and two Workers of the
  port's ``serve`` behind the supervisor's router; one replica is killed
  mid-request and every request still gets exactly one response, none lost
  and none duplicated (``tests/test_serveplane.py``'s chaos case on port
  replicas).
"""

import json
import threading
import time
from pathlib import Path

from tests.torch_worlds import supervise

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    from pytorch_operator_tpu.api import load_job

    return load_job(ROOT / "examples" / f"{name}.yaml")


# The generate example's args are the JAX example's (16 layers, 256 new
# tokens); the test cuts its depth and length on the host, after them
# (argparse keeps the last value).
GENERATE_CUT = ["--layers", "2", "--max-new-tokens", "32"]


def test_generate_example(tmp_path):
    job = _load("generate-torch")
    (master,) = job.spec.replica_specs.values()
    (jax_master,) = _load("generate").spec.replica_specs.values()
    assert master.template.args == jax_master.template.args
    master.template.args = master.template.args + GENERATE_CUT
    done, log, records = supervise(tmp_path, job)
    assert done.is_succeeded(), log[-3000:]
    result = json.loads(log.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["config"] == "0.3b"
    from pytorch_operator_tpu_torch.models import llama

    two_layers = llama.Llama(llama.llama_0_3b(n_layers=2), device="meta")
    assert result["params_m"] == round(sum(p.numel() for p in two_layers.parameters()) / 1e6, 1)
    assert result["value"] > 0 and result["batch"] == 8, result
    assert "first_step" in {r["event"] for r in records}


def test_dataplane_example(tmp_path):
    from pytorch_operator_tpu.checkpoint.integrity import latest_verified_step, list_steps

    job = _load("dataplane-torch")
    done, log, records = supervise(tmp_path, job)
    assert done.is_succeeded(), log[-3000:]
    result = json.loads(log.strip().splitlines()[-1])
    feed = result["feed"]
    assert feed["workers"] == 2 and 1 <= feed["depth"] <= 8, feed
    committed = sorted(r["step"] for r in records if r["event"] == "checkpoint_committed")
    assert committed == list(range(10, 61, 10)), records
    (ckpt,) = [p for p in (tmp_path / "state" / "checkpoints").rglob("*") if p.is_dir()
               and any(q.suffix == ".digest" for q in p.iterdir())]
    # The JAX reconciler's probe verifies the newest step (the run's final
    # save after the async ones).
    assert latest_verified_step(ckpt) == list_steps(ckpt)[-1] >= 60


def test_serve_fleet_example_survives_a_replica_kill(tmp_path):
    from pytorch_operator_tpu.controller.store import key_to_fs
    from pytorch_operator_tpu.controller.supervisor import Supervisor
    from pytorch_operator_tpu.serving import Spool, make_request
    from pytorch_operator_tpu.serving.router import front_spool_dir, serve_root_dir
    from pytorch_operator_tpu.serving.slo import SLOStats

    state = tmp_path / "state"
    job = _load("serve-fleet-torch")
    job.spec.port = None
    sup = Supervisor(state_dir=state, poll_interval=0.05)
    stop, pump_errors = threading.Event(), []

    def pump():
        while not stop.is_set():
            try:
                sup.sync_once()
            except Exception as e:  # noqa: BLE001 — reported by the test
                pump_errors.append(repr(e))
            stop.wait(sup.poll_interval)

    pump_thread = threading.Thread(target=pump, daemon=True)
    try:
        key = sup.submit(job)
        pump_thread.start()
        status = state / "status" / key_to_fs(key)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            active = [h for h in sup.runner.list_for_job(key) if h.is_active()]
            reported = len(list(status.glob("*-[0-9].jsonl"))) if status.is_dir() else 0
            if len(active) == 3 and reported == 3:
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"replicas not ready (pump errors: {pump_errors[:3]})")

        front = Spool(front_spool_dir(serve_root_dir(state), key, job.spec.serving))
        rids = front.enqueue_batch(
            [make_request(prompt_len=8, max_new_tokens=64) for _ in range(24)]
        )
        # Kill worker-0 once the fleet answers: the second wave is in flight.
        while not any(front.responses.glob("*.json")):
            assert time.monotonic() < deadline + 120, pump_errors[:3]
            time.sleep(0.02)
        (victim,) = [h for h in sup.runner.list_for_job(key)
                     if h.replica_type.value == "Worker" and h.index == 0]
        sup.runner.inject_kill(victim.name)

        stats, pending = SLOStats(), set(rids)
        stats.offered = len(rids)
        collect = time.monotonic() + 120
        while pending and time.monotonic() < collect:
            for p in list(front.responses.glob("*.json")):
                if p.stem in pending and (resp := front.read_response(p.stem)) is not None:
                    stats.account(resp)
                    pending.discard(p.stem)
            time.sleep(0.05)
        files = {p.stem for p in front.responses.glob("*.json")}
        finish = time.monotonic() + 90
        while time.monotonic() < finish and not sup.store.get(key).is_finished():
            time.sleep(0.1)
        done = sup.store.get(key)
    finally:
        stop.set()
        pump_thread.join(timeout=10)
        sup.shutdown()
    assert not pending, f"lost {len(pending)} of {len(rids)}"
    assert files == set(rids), "a response for an id nobody submitted"
    summary = stats.summary()
    assert summary["ok"] == summary["offered"] == 24, summary
    assert summary["errors"] == 0 and summary["shed"] == 0, summary
    assert summary["rerouted"] >= 1, summary  # the kill caught requests in flight
    assert not pump_errors, pump_errors[:3]
    assert done.is_succeeded(), done.status
