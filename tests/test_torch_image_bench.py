"""The port's image benches and their parts against the JAX package's, on the
CPU.

- ``datasets.synthetic_images`` and ``pack --dataset synthetic``: the JAX
  bytes for the same arguments.
- ``trainer.open_image_feed``: JAX's batches from one file, inline and
  prefetched; the refusals of ``tests/test_resnet_bench.py`` (labels beyond
  ``--classes``, a bad label past the first chunk, a file smaller than the
  batch) and of ViT (non-square images), each before any batch is drawn.
- ``trainer.timed_windows``: JAX's protocol, call for call.

The benches' runs are in ``tests/test_torch_image_bench_resnet.py`` and
``tests/test_torch_image_bench_vit.py``, the examples under the supervisor
in ``tests/test_torch_image_examples.py``: one file each, so that no file
holds a worker of a ``--dist loadfile`` run much longer than the others.
"""

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
from pytorch_operator_tpu_torch.workloads import resnet_bench, trainer, vit_bench

SMALL = dict(batch_size=8, image_size=32, classes=10, steps=2, warmup=1, device="cpu",
             log=lambda m: None)


@pytest.mark.parametrize("args", [(4, 8, 8, 10, 0), (3, 5, 7, 1000, 9)])
def test_synthetic_images_equal_jax(args):
    *shape, seed = args
    for got, want in zip(port_datasets.synthetic_images(*shape, seed=seed),
                         jax_datasets.synthetic_images(*shape, seed=seed)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


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
