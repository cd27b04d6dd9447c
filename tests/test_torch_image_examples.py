"""The port's image examples under the unchanged supervisor, on the CPU
(moved from ``tests/test_torch_image_bench.py``).

- ``latency_probe`` and the three ``examples/*-torch.yaml`` jobs: each job
  succeeds; the probe's ``schedule_to_first_step_latency`` and
  ``latency_phases`` record.
"""

import json
from pathlib import Path

import pytest

from tests.torch_worlds import supervise

ROOT = Path(__file__).resolve().parents[1]
_supervise = supervise


@pytest.mark.parametrize("example", ["resnet-torch", "vit-torch", "latency-probe-torch"])
def test_example_runs_under_the_supervisor(tmp_path, example):
    """Each new example, as written (on the host: cpu_devices), runs to
    success under the unchanged supervisor and reports its first step."""
    from pytorch_operator_tpu.api import load_job
    from pytorch_operator_tpu.controller.supervisor import schedule_to_first_step_latency

    done, log, records = _supervise(tmp_path, load_job(ROOT / "examples" / f"{example}.yaml"))
    assert done.is_succeeded(), log[-3000:]
    assert schedule_to_first_step_latency(done) is not None
    events = {r["event"] for r in records}
    assert "first_step" in events, records
    if example == "latency-probe-torch":
        (phases,) = [r for r in records if r["event"] == "latency_phases"]
        assert set(phases) - {"event", "ts"} == {
            "main_entry", "rendezvous_s", "import_torch_s", "client_init_s", "first_exec_s"}
        assert "first step done on cpu" in log
    else:
        result = json.loads(log.strip().splitlines()[-1])
        assert result["device"] == "cpu" and result["unit"] == "images/sec/chip"
        assert "metrics" in events
