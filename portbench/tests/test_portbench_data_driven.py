"""A configuration, a mix, a cell's limits and a per-layer metric added as
files, with entries in ``BENCHMARK.json``, run without an edit of the
harness: a copy of the benchmark gains them in a temporary directory and
the harness, pointed at that copy, picks each up by name."""

import json
import shutil

from portbench import harness
from portbench.tests.conftest import TINY, run_tiny

PROBE = '''
def read(run):
    return float(run.window.steps)
'''
# A reader of a metric that moves an end-to-end metric a training run does
# not measure: never called there.
SERVE_PROBE = '''
def read(run):
    raise AssertionError("read in a cell that does not report what it moves")
'''


def test_added_files_are_found_by_name(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    base = json.loads((harness.ROOT / "portbench/configs/mistral-7b.json").read_text())
    (tmp_path / "portbench/configs/tiny-probe.json").write_text(
        json.dumps({**base, **TINY, "name": "tiny-probe", "torch_dtype": "float32"}))
    (tmp_path / "portbench/mixes/train.b2.s32.json").write_text(
        json.dumps({"kind": "train", "batch": 2, "seq_len": 32, "remat": "full", "pool": 3}))
    (tmp_path / "portbench/checks/tiny-probe.train.json").write_text(
        json.dumps({"steps": 2, "limits": {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4}}))
    (tmp_path / "portbench/metrics/probe_steps.py").write_text(PROBE)
    (tmp_path / "portbench/metrics/probe_serve.py").write_text(SERVE_PROBE)
    bench["configs"].append({"name": "tiny-probe", "source": "a test", "reduced": [], "why": "a test",
                             "file": "portbench/configs/tiny-probe.json"})
    bench["workloads"].append({"name": "tiny-probe.train", "config": "tiny-probe", "chips": 1,
                               "traffic": "train.b2.s32", "why": "a test"})
    bench["per_layer"].append({"name": "probe_steps", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "training step", "moves": "train_tokens_per_s"})
    bench["end_to_end"].append({"name": "ttft_p95_ms", "unit": "ms", "better": "lower", "bound": 0.03,
                                "source": "host_clock"})
    bench["per_layer"].append({"name": "probe_serve", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "serving", "moves": "ttft_p95_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("tiny-probe.train", tmp_path)
    assert cell.mix["seq_len"] == 32 and cell.config["hidden_size"] == TINY["hidden_size"]
    traced = run_tiny(cell, traced=True)
    assert traced["correct"], traced["checks"]
    # On the CPU the card's readers find nothing to read; the probe reads the
    # untraced window, which a traced run measures before its traced one.
    assert set(traced["metrics"]) == {"probe_steps"}
    assert 1 <= traced["metrics"]["probe_steps"]["value"] < traced["attempted"]
    plain = run_tiny(cell)
    assert set(plain["metrics"]) == {"train_tokens_per_s", "setup_s"}  # no card: no peak memory
