"""Nothing that the benchmark runs loads JAX or the JAX package.

Each check runs in a fresh interpreter and compares the top-level name of
every loaded module (the part before the first dot) whole, so the port,
``pytorch_operator_tpu_torch``, passes where ``pytorch_operator_tpu`` would
not.
"""

import json
import subprocess
import sys

from portbench import harness

_PROBE = """
import json, sys
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_RUN = """
import torch
from portbench.tests.conftest import run_tiny, tiny_cell
run_tiny(tiny_cell("mistral-7b.train.s32k"))
"""


def _top_level_names(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", _PROBE.format(body=body)], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_the_harness_loads_no_jax():
    names = _top_level_names(_RUN)
    assert "pytorch_operator_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_the_reference_loads_neither_jax_nor_the_port():
    names = _top_level_names("import portbench.reference, portbench.weights, portbench.check")
    assert not names & set(harness.FORBIDDEN)
    assert "pytorch_operator_tpu_torch" not in names


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pytorch_operator_tpu_torch_probe", object())
    assert "pytorch_operator_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pytorch_operator_tpu.probe", object())
    assert harness.forbidden_modules() == ["pytorch_operator_tpu"]
