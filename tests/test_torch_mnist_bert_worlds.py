"""The digit CNN and BERT in worlds of two processes on the CPU (gloo,
``tests/torch_worlds.py``), and their examples under the unchanged
supervisor.

- ``mnist_train.run`` at dp=2 (f32 compute, one epoch of B128): every
  step's loss equal to one process's within ``WORLD_LOSS_RTOL`` (the mean of
  the two ranks' gradients is the global batch's), both ranks the same test
  accuracy (the padded test batch's counts summed over the world).
- ``bert_fsdp.run`` at fsdp=2 and dp=2 (``bert_tiny``, f32, 1 + 4 steps):
  every step's loss within ``WORLD_LOSS_RTOL`` of one process's; under
  fsdp=2 each rank's parameter and AdamW bytes about half of one process's
  (the ZeRO claim of ``tests/test_workloads_lm.py:27-39``, on bytes: FSDP2's
  dim-0 chunks are ceil-sized, and AdamW's step counts are whole on every
  rank), under dp=2 all of them.
- ``examples/mnist-dist-cpu-torch.yaml`` (1 Master + 1 Worker over gloo,
  BASELINE.json:7) and ``examples/bert-fsdp-torch.yaml`` under the
  supervisor: each succeeds and reports its first step.

Readings on the CPU: the worlds' losses within 2.4e-7 (mnist) and 1.7e-7
(BERT) of one process's, relative; under fsdp=2 each rank 167,300 parameter
and 334,760 AdamW bytes of one process's 334,600 and 669,360.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_operator_tpu_torch.workloads import bert_fsdp, mnist_train
from tests.torch_worlds import run_world, supervise

ROOT = Path(__file__).resolve().parents[1]
WORLD_LOSS_RTOL = 1e-5
HALF_RTOL = 0.01
MNIST = dict(epochs=1, dtype=torch.float32)
BERT = dict(batch_size=16, seq_len=32, steps=4, warmup=1, lr=3e-4)


@pytest.fixture(scope="module")
def worlds():
    """One process's runs here, and the same runs in one world of two
    ranks."""
    one = {
        "mnist": mnist_train.run(device="cpu", log=lambda m: None, **MNIST),
        "bert": bert_fsdp.run(device="cpu", log=lambda m: None, **BERT),
    }
    calls = [
        ("workload", ("mnist_train", MNIST)),
        ("workload", ("bert_fsdp", dict(BERT, mesh_spec="fsdp=2"))),
        ("workload", ("bert_fsdp", dict(BERT, mesh_spec="dp=2"))),
    ]
    ranks = run_world("many", calls, n=2, timeout=240)
    return one, {name: [r[i] for r in ranks] for i, name in enumerate(["mnist", "fsdp", "dp"])}


def test_mnist_dp2_equals_one_process(worlds):
    one, two = worlds
    want = one["mnist"]
    for r in two["mnist"]:
        assert (r["steps"], r["global_batch"], r["devices"]) == (want["steps"], 128, 2)
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=WORLD_LOSS_RTOL)
        assert r["test_accuracy"] == two["mnist"][0]["test_accuracy"]
    assert abs(two["mnist"][0]["test_accuracy"] - want["test_accuracy"]) <= 1 / 359


@pytest.mark.parametrize("mesh", ["fsdp", "dp"])
def test_bert_world_equals_one_process(worlds, mesh):
    one, two = worlds
    want = one["bert"]
    share = 0.5 if mesh == "fsdp" else 1.0
    for r in two[mesh]:
        assert (r["world"], r["devices"], r["backend"], r["mesh"]) == (2, 2, "gloo", {mesh: 2})
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=WORLD_LOSS_RTOL)
        assert r["param_bytes"] == pytest.approx(share * want["param_bytes"], rel=HALF_RTOL)
        assert r["optimizer_state_bytes"] == pytest.approx(
            share * want["optimizer_state_bytes"], rel=HALF_RTOL)
    if mesh == "fsdp":
        assert sum(r["param_bytes"] for r in two[mesh]) >= want["param_bytes"]


@pytest.mark.parametrize("example", ["mnist-dist-cpu-torch", "bert-fsdp-torch"])
def test_example_runs_under_the_supervisor(tmp_path, example):
    from pytorch_operator_tpu.api import load_job
    from pytorch_operator_tpu.controller.supervisor import schedule_to_first_step_latency

    done, log, records = supervise(tmp_path, load_job(ROOT / "examples" / f"{example}.yaml"))
    assert done.is_succeeded(), log[-3000:]
    assert schedule_to_first_step_latency(done) is not None
    assert "first_step" in {r["event"] for r in records}, records
    if example.startswith("mnist"):
        assert "test_accuracy=" in log and "dp=2" in log
    else:
        import json

        result = json.loads(log.strip().splitlines()[-1])
        assert result["device"] == "cpu" and result["final_accuracy"] >= 0.9
