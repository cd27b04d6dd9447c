"""The port's serving entry points in a world of two processes (ROADMAP
Queue 3's fault, closed here): ``generate``, ``serve`` and ``quality_eval``
resolve each rank's own device (``runtime.device.world_device``, as
``llama_train`` does), and ``decode_tokens_per_sec_per_chip`` is the
process's tokens/s over the world's devices, as the JAX workloads divide by
``jax.device_count()``.

- Two ranks with two cards faked: each entry point's device is
  ``cuda:<rank>`` (before the repair both landed on ``cuda``, i.e. card 0).
- ``serve.run`` in each rank: per-chip = tokens/s ÷ 2; its keys are JAX
  ``serve.run``'s on 2 virtual CPU devices, plus the port's own.
- ``generate.main`` as Master + Worker under the unchanged supervisor: each
  replica's ``metrics`` record has tokens/s ÷ per-chip = 2, and the
  Master's result has JAX ``generate.run``'s keys on 2 virtual devices
  (``devices`` 2), plus the port's own.
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

from pytorch_operator_tpu_torch.data import pack
from tests import torch_worlds

ROOT = Path(__file__).resolve().parents[1]
GEN_ARGS = ["--config", "tiny", "--batch-size", "2", "--prompt-len", "8", "--max-new-tokens", "4"]
# Keys the port adds to JAX's results (timings, the device's name, the flash
# launch count of a call).
PORT_GENERATE_KEYS = {"device", "generate_s", "prefill_s", "flash_launches_per_generate"}
PORT_SERVE_KEYS = {"device"}

_JAX_RUNS = """
import pickle, sys
import tests.jaxenv
import jax
from pytorch_operator_tpu.serving import Spool
from pytorch_operator_tpu.workloads import generate, serve
assert jax.device_count() == 2, jax.devices()
gen = generate.run(config="tiny", batch_size=2, prompt_len=8, max_new_tokens=4, log=lambda m: None)
sp = Spool(sys.argv[2])
for _ in range(2):
    sp.submit(prompt_len=5, max_new_tokens=4)
st = serve.run(config="tiny", spool_dir=sys.argv[2], slots=2, chunk=8, block=4, max_decode_len=48,
               max_requests=2, idle_timeout=60, log=lambda m: None)
pickle.dump({"generate": gen, "serve": st}, open(sys.argv[1], "wb"))
"""


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_entry")
    env = dict(__import__("os").environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run([sys.executable, "-c", _JAX_RUNS, str(d / "out.pkl"), str(d / "spool")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return pickle.loads((d / "out.pkl").read_bytes())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_entry")
    (d / "corpus.txt").write_bytes(bytes(range(256)) * 4)
    pack.main(["--dataset", "text", "--input", str(d / "corpus.txt"), "--seq-len", "16",
               "--out", str(d / "eval.bin")])
    return torch_worlds.run_world("entry_devices", str(d / "eval.bin"), str(d / "spool"))


def test_each_rank_resolves_its_own_device(ranks):
    for rank, r in enumerate(ranks):
        assert r["seen"] == {k: f"cuda:{rank}" for k in ("generate", "serve", "quality_eval")}, r["seen"]


def test_serve_per_chip_rate_and_keys_in_a_world(ranks, jax_results):
    want = jax_results["serve"]
    for r in ranks:
        st = r["serve"]
        assert st["served"] == 2 and st["device"] == "cpu"
        assert st["decode_tokens_per_sec_per_chip"] == round(st["decode_tokens_per_sec"] / 2, 1)
        assert set(st) - set(want) == PORT_SERVE_KEYS and set(want) <= set(st)
    assert want["decode_tokens_per_sec_per_chip"] == round(want["decode_tokens_per_sec"] / 2, 1)


def test_generate_main_in_a_world_under_the_supervisor(tmp_path, jax_results):
    from pytorch_operator_tpu.api import ProcessTemplate, Resources
    from pytorch_operator_tpu.controller import Supervisor
    from pytorch_operator_tpu.controller.progress import job_status_dir
    from pytorch_operator_tpu.controller.store import job_key
    from tests.testutil import new_job

    sup = Supervisor(state_dir=tmp_path / "state", poll_interval=0.1)
    job = new_job(name="generate-torch", workers=1)
    job.spec.port = None
    for rs in job.spec.replica_specs.values():
        rs.template = ProcessTemplate(module="pytorch_operator_tpu_torch.workloads.generate",
                                      args=GEN_ARGS + ["--json"], resources=Resources(cpu_devices=1))
    try:
        done = sup.run(job, timeout=240)
    finally:
        sup.shutdown()
    logs = {who: (tmp_path / "state" / "logs" / f"default_generate-torch-{who}-0.log").read_text()
            for who in ("master", "worker")}
    assert done.is_succeeded(), logs
    status = job_status_dir(tmp_path / "state" / "status", job_key(done))
    for who in ("master", "worker"):
        recs = [json.loads(x) for x in (status / f"{who}-0.jsonl").read_text().splitlines()]
        (m,) = [r for r in recs if r["event"] == "metrics"]
        assert m["decode_tokens_per_sec"] / m["decode_tokens_per_sec_per_chip"] == 2
        assert any(r["event"] == "rendezvous_join" and r["world"] == 2 for r in recs)
    result = json.loads(logs["master"].strip().splitlines()[-1])
    want = jax_results["generate"]
    assert set(result) - set(want) == PORT_GENERATE_KEYS and set(want) <= set(result)
    assert result["devices"] == want["devices"] == 2
    assert '"metric"' not in logs["worker"]
