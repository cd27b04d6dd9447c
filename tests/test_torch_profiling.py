"""The port's profile report (pytorch_operator_tpu_torch/profiling.py) on a
trace that ``llama_train --profile-dir`` writes on the CPU.

``torch.profiler`` writes a Chrome-trace JSON; the report reads its host
plane here (a CPU run has no ``cuda`` plane, and asking for one returns
None, as the JAX tool does for a missing device). The busy total is a
partition of the trace: self times, so the category shares sum to 100%.
"""

import json
import subprocess
import sys

import pytest

from pytorch_operator_tpu_torch import profiling
from pytorch_operator_tpu_torch.workloads import llama_train

STEPS = 4


@pytest.fixture(scope="module")
def trace_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("prof")
    llama_train.main([
        "--device", "cpu", "--batch-size", "4", "--seq-len", "32", "--steps", str(STEPS),
        "--warmup", "1", "--profile-dir", str(d),
    ])
    return d


def test_profile_dir_holds_a_chrome_trace(trace_dir):
    path = profiling.find_trace(trace_dir)
    trace = json.loads(path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "step" in names and any(str(n).startswith("aten::") for n in names)


def test_report_parses_the_cpu_trace(trace_dir):
    report = profiling.device_report(trace_dir, device_substr="cpu")
    assert report["device"] == "cpu"
    assert report["steps"] == STEPS and report["mean_step_s"] > 0
    assert 0 < report["busy_s"]
    assert report["categories"] and report["top_ops"]
    total = sum(c["pct_of_busy"] for c in report["categories"])
    assert total == pytest.approx(100.0, abs=0.5), total
    assert any(r["op"] == "aten::mm" for r in report["top_ops"])


def test_report_missing_device_returns_none(trace_dir):
    assert profiling.device_report(trace_dir, device_substr="cuda") is None
    assert profiling.device_report(trace_dir, device_substr="NOPE") is None


def test_cli_human_and_json(trace_dir):
    cmd = [sys.executable, "-m", "pytorch_operator_tpu_torch.profiling", str(trace_dir)]
    out = subprocess.run(cmd + ["--device", "cpu", "--top", "5"], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "by op category" in out.stdout and f"steps: {STEPS}" in out.stdout
    j = subprocess.run(cmd + ["--device", "cpu", "--json", "--top", "3"], capture_output=True, text=True)
    assert j.returncode == 0, j.stderr
    data = json.loads(j.stdout)
    assert len(data["top_ops"]) <= 3
    assert {"device", "steps", "mean_step_s", "busy_s", "categories", "top_ops"} <= set(data)
    miss = subprocess.run(cmd, capture_output=True, text=True)  # default --device cuda
    assert miss.returncode == 1 and "try --device cpu" in miss.stderr


def test_missing_dir_and_bad_trace_error_cleanly(tmp_path, capsys):
    assert profiling.main([str(tmp_path / "nope")]) == 1
    (tmp_path / "t.pt.trace.json").write_text('{"traceEvents": [')
    assert profiling.main([str(tmp_path), "--device", "cpu"]) == 1
    assert "error:" in capsys.readouterr().err


def test_self_time_partition_on_a_nested_trace(tmp_path):
    """Nested host events charge their self time; the kernels of a stream
    form the card's plane, whose step runs from its projected ``step``
    range's start (a range that ends before the backward's kernels) to the
    plane's last event."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "pid": 1, "tid": 1, "ts": 0, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 2, "dur": 6},
        {"ph": "X", "cat": "user_annotation", "name": "step", "pid": 1, "tid": 1, "ts": 0, "dur": 12},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::flash_fwd_sm90<128>(Params)",
         "pid": 0, "tid": 7, "ts": 3, "dur": 4, "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "void flash_fwd_sm90<128>(Params)", "pid": 0, "tid": 7,
         "ts": 8, "dur": 2, "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0, "tid": 7, "ts": 3,
         "dur": 4, "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": 1, "tid": 1, "ts": 0,
         "dur": 100},
    ]
    (tmp_path / "h.1.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    cpu = profiling.device_report(tmp_path, "cpu")
    assert cpu["steps"] == 1 and cpu["busy_s"] == pytest.approx(10e-6)
    assert {r["op"]: r["s_per_step"] for r in cpu["top_ops"]} == pytest.approx(
        {"aten::linear": 4e-6, "aten::mm": 6e-6}
    )
    card = profiling.device_report(tmp_path, "cuda")
    assert card["device"] == "cuda:0" and card["steps"] == 1
    # The step runs from its projected start (3) to the plane's last event (10).
    assert card["busy_s"] == pytest.approx(6e-6) and card["busy_frac_of_steps"] == pytest.approx(6 / 7)
    assert card["categories"][0]["category"] == "flash_fwd_sm90"
    assert card["top_ops"][0]["op"].startswith("void (anonymous namespace)::flash_fwd_sm90")
