"""The port's image benches and their parts against the JAX package's, on the
CPU.

- ``datasets.synthetic_images`` and ``pack --dataset synthetic``: the JAX
  bytes for the same arguments.
- ``trainer.open_image_feed``: JAX's batches from one file, inline and
  prefetched; the refusals of ``tests/test_resnet_bench.py`` (labels beyond
  ``--classes``, a bad label past the first chunk, a file smaller than the
  batch) and of ViT (non-square images), each before any batch is drawn.
- ``trainer.timed_windows``: JAX's protocol, call for call.
- ``resnet_bench``, ``vit_bench`` and ``resnet_ab``: the JAX result keys
  (plus the port's ``device``, ``peak_mem_bytes``, ``losses`` and ResNet's
  ``memory_format``), losses that fall, the file path inline and prefetched
  with equal losses step for step.
- ``latency_probe`` and the three ``examples/*-torch.yaml`` jobs under the
  unchanged supervisor: each job succeeds; the probe's
  ``schedule_to_first_step_latency`` and ``latency_phases`` record.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.data import pack as jax_pack
from pytorch_operator_tpu.data import pack_arrays
from pytorch_operator_tpu.workloads import datasets as jax_datasets
from pytorch_operator_tpu.workloads import trainer as jax_trainer
from pytorch_operator_tpu_torch.data import pack as port_pack
from pytorch_operator_tpu_torch.workloads import datasets as port_datasets
from pytorch_operator_tpu_torch.workloads import resnet_ab, resnet_bench, trainer, vit_bench

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(batch_size=8, image_size=32, classes=10, steps=2, warmup=1, device="cpu",
             log=lambda m: None)


@pytest.mark.parametrize("args", [(4, 8, 8, 10, 0), (3, 5, 7, 1000, 9)])
def test_synthetic_images_equal_jax(args):
    *shape, seed = args
    for got, want in zip(port_datasets.synthetic_images(*shape, seed=seed),
                         jax_datasets.synthetic_images(*shape, seed=seed)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(NotImplementedError, match="MNIST"):
        port_datasets.digits()


def test_pack_synthetic_equals_jax(tmp_path):
    args = ["--dataset", "synthetic", "--n", "12", "--height", "6", "--width", "4",
            "--classes", "1000", "--seed", "3"]
    assert port_pack.main(args + ["--out", str(tmp_path / "p.bin")]) == 0
    assert jax_pack.main(args + ["--out", str(tmp_path / "j.bin")]) == 0
    for suffix in ("", ".meta.json"):
        assert (tmp_path / f"p.bin{suffix}").read_bytes() == (tmp_path / f"j.bin{suffix}").read_bytes()


def _packed(tmp_path, n=32, h=16, w=16, classes=10, name="syn.bin"):
    out = tmp_path / name
    port_pack.main(["--dataset", "synthetic", "--n", str(n), "--height", str(h), "--width", str(w),
                    "--classes", str(classes), "--out", str(out)])
    return out


@pytest.mark.parametrize("prefetch", [0, 2])
def test_image_feed_batches_equal_jax(tmp_path, prefetch):
    """Two chunks of the port's feed (inline, and prefetched on the feed
    threads) equal the JAX feed's: bf16 images stacked ``[chunk, B, H, W,
    C]``, the labels."""
    from pytorch_operator_tpu.parallel import make_mesh

    import jax

    f = _packed(tmp_path, n=24)
    want_next, want_loader = jax_trainer.open_image_feed(
        str(f), batch=8, chunk=2, classes=10, mesh=make_mesh({"dp": jax.device_count()}))
    got_next, got_loader = trainer.open_image_feed(
        str(f), batch=8, chunk=2, classes=10, device="cpu", prefetch=prefetch)
    try:
        for _ in range(2):
            (wx, wy), (gx, gy) = want_next(), got_next()
            assert gx.dtype == torch.bfloat16 and tuple(gx.shape) == (2, 8, 16, 16, 3)
            np.testing.assert_array_equal(gx.float().numpy(), np.asarray(wx, np.float32))
            np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    finally:
        want_loader.close()
        got_loader.close()


def _bad_tail(tmp_path, label):
    x = np.random.default_rng(0).random((64, 16, 16, 3), np.float32)
    y = np.full((64,), 3, np.int32)
    y[-1] = label  # outside any first-chunk sample
    out = tmp_path / f"bad{label}.bin"
    pack_arrays(out, {"x": x, "y": y})
    return out


REFUSALS = {
    "labels_exceed_classes": (lambda p: _packed(p, classes=10), dict(classes=4), "classes"),
    "bad_label_past_first_chunk": (lambda p: _bad_tail(p, 10), {}, "classes"),
    "negative_label": (lambda p: _bad_tail(p, -1), {}, "classes"),
    "file_smaller_than_batch": (lambda p: _packed(p, n=4), {}, "records < global batch"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_image_feed_refusals(tmp_path, case):
    """``tests/test_resnet_bench.py``'s refusals, raised by the port's
    ``run_benchmark`` before any step."""
    make, over, match = REFUSALS[case]
    f = make(tmp_path)
    kw = dict(SMALL, depth=18, classes=10)
    kw.update(over)
    with pytest.raises(ValueError, match=match):
        resnet_bench.run_benchmark(data_file=str(f), **kw)


def test_vit_refuses_non_square_and_fieldless_files(tmp_path):
    f = _packed(tmp_path, h=16, w=8)
    with pytest.raises(ValueError, match="square"):
        vit_bench.run_benchmark(variant="s16", data_file=str(f), **SMALL)
    g = tmp_path / "tokens.bin"
    pack_arrays(g, {"tokens": np.zeros((16, 8), np.int32)})
    with pytest.raises(ValueError, match="fields named 'x'"):
        trainer.open_image_feed(str(g), batch=8, chunk=1, classes=10, device="cpu")


class _Clock:
    """A fake window and fence that log their calls."""

    def __init__(self):
        self.calls = []
        self.n = 0

    def run_window(self):
        self.n += 1
        self.calls.append(("run", self.n))
        return self.n

    def fence(self, tok):
        self.calls.append(("fence", tok))


@pytest.mark.parametrize("windows,profile", [(1, False), (3, False), (3, True)])
def test_timed_windows_follows_jax(tmp_path, windows, profile):
    """The same calls in the same order as JAX's: fenced windows (skipped for
    one window or when profiling), then the depth-1 lookahead run; the same
    progress records and return shape."""
    out = {}
    for name, fn in (("jax", jax_trainer.timed_windows), ("port", trainer.timed_windows)):
        clock, prog = _Clock(), []
        dt, dt_sustained, n_win = fn(
            clock.run_window, clock.fence, windows=windows,
            profile_dir=str(tmp_path / name) if profile else None, log=lambda m: None,
            progress=lambda done, measured, dt: prog.append((done, measured)),
        )
        out[name] = (clock.calls, prog, dt is None, n_win)
        assert dt_sustained > 0
    assert out["port"] == out["jax"]


def test_chunk_plan_follows_jax():
    """Chunks of min(30, steps), steps rounded up to whole chunks, warmup to
    whole chunks (resnet_bench.py:241-243)."""
    import math

    for steps, warmup in [(1, 1), (4, 1), (30, 5), (31, 5), (45, 60), (2, 0)]:
        chunk = min(30, max(steps, 1))
        want = (chunk, math.ceil(max(steps, 1) / chunk) * chunk, max(1, round(max(warmup, 1) / chunk)))
        assert trainer.chunk_plan(steps, warmup) == want


@pytest.fixture(scope="module")
def jax_results():
    from pytorch_operator_tpu.workloads import resnet_ab as jax_ab
    from pytorch_operator_tpu.workloads import resnet_bench as jax_resnet
    from pytorch_operator_tpu.workloads import vit_bench as jax_vit

    kw = dict(batch_size=8, image_size=32, classes=10, steps=1, warmup=1, log=lambda m: None)
    return {
        "resnet": jax_resnet.run_benchmark(depth=18, **kw),
        "vit": jax_vit.run_benchmark(variant="s16", **kw),
        "ab": jax_ab.run_ab(variant_names=["plain", "s2d@16"], depth=18, batch_size=8,
                            image_size=32, steps=1, rounds=1, log=lambda m: None),
    }


def test_resnet_bench_result_keys_and_training(jax_results):
    r = resnet_bench.run_benchmark(depth=18, windows=2, **dict(SMALL, steps=4))
    want = jax_results["resnet"]
    assert set(r) - set(want) == {"device", "peak_mem_bytes", "memory_format", "losses"}
    assert set(want) <= set(r)
    assert r["metric"] == want["metric"] == "resnet18_train_images_per_sec_per_chip"
    assert (r["global_batch"], r["devices"], r["input"], r["device"]) == (8, 1, "synthetic", "cpu")
    assert np.isfinite(r["final_loss"]) and r["final_loss"] < np.log(10)
    assert r["value"] > 0 and r["min_window_images_per_sec_per_chip"] > 0


def test_resnet_bench_file_inline_equals_prefetched(tmp_path):
    f = _packed(tmp_path, n=32)
    runs = [resnet_bench.run_benchmark(depth=18, data_file=str(f), prefetch=p, **dict(SMALL, steps=3))
            for p in (0, 2)]
    assert runs[0]["input"] == "file" and runs[0]["losses"] == runs[1]["losses"]
    assert len(runs[0]["losses"]) == 3 + 3  # one warm chunk of 3, one window of 3


def test_vit_bench_result_keys_and_training(jax_results, tmp_path):
    want = jax_results["vit"]
    for attn in ("dense", "flash"):
        r = vit_bench.run_benchmark(variant="s16", attn_impl=attn, **dict(SMALL, steps=4))
        assert set(r) - set(want) == {"device", "peak_mem_bytes", "losses"} and set(want) <= set(r)
        assert r["metric"] == want["metric"] and r["params_m"] == want["params_m"]
        assert np.isfinite(r["final_loss"]) and r["final_loss"] < np.log(10)
    f = _packed(tmp_path, n=16)
    r = vit_bench.run_benchmark(variant="s16", data_file=str(f), **dict(SMALL, image_size=None))
    assert r["input"] == "file"
    with pytest.raises(ValueError, match="no effect without --remat"):
        vit_bench.run_benchmark(variant="s16", remat_policy="dots", **SMALL)


def test_resnet_ab_result_follows_jax(jax_results):
    """Per variant the JAX fields, a batch override, and the first step's
    loss, equal for the plain and space-to-depth stems (one function, one
    seed)."""
    r = resnet_ab.run_ab(variant_names=["plain", "s2d@16"], depth=18, batch_size=8, image_size=32,
                         steps=2, rounds=2, device="cpu", log=lambda m: None)
    want = jax_results["ab"]
    assert set(r) - set(want) == {"device"} and set(want) <= set(r)
    for spec in ("plain", "s2d@16"):
        assert set(r[spec]) - set(want[spec]) == {"first_loss"} and set(want[spec]) <= set(r[spec])
    assert (r["plain"]["batch"], r["s2d@16"]["batch"], r["plain"]["vs_first"]) == (8, 16, 1.0)
    same = resnet_ab.run_ab(variant_names=["plain", "s2d"], depth=18, batch_size=8, image_size=32,
                            steps=1, rounds=1, device="cpu", log=lambda m: None)
    assert same["s2d"]["first_loss"] == pytest.approx(same["plain"]["first_loss"], abs=2e-3)
    with pytest.raises(SystemExit, match="unknown variant"):
        resnet_ab.parse_variant("nope@8")


def _supervise(tmp_path, job):
    from pytorch_operator_tpu.controller import Supervisor
    from pytorch_operator_tpu.controller.progress import job_status_dir
    from pytorch_operator_tpu.controller.store import job_key

    job.spec.port = None
    sup = Supervisor(state_dir=tmp_path / "state", poll_interval=0.1)
    try:
        done = sup.run(job, timeout=240)
    finally:
        sup.shutdown()
    name = job.metadata.name
    log = (tmp_path / "state" / "logs" / f"default_{name}-master-0.log").read_text()
    status = job_status_dir(tmp_path / "state" / "status", job_key(done)) / "master-0.jsonl"
    records = [json.loads(x) for x in status.read_text().splitlines()] if status.exists() else []
    return done, log, records


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
