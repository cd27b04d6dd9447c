"""The port's ResNet benches against the JAX package's, on the CPU (moved
from ``tests/test_torch_image_bench.py``, one file a bench's runs).

- ``resnet_bench`` and ``resnet_ab``: the JAX result keys (plus the port's
  ``device``, ``peak_mem_bytes``, ``losses`` and ResNet's
  ``memory_format``), losses that fall, the file path inline and prefetched
  with equal losses step for step.
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from tests.test_torch_image_bench import SMALL, _packed
from pytorch_operator_tpu_torch.workloads import resnet_ab, resnet_bench


@pytest.fixture(scope="module")
def jax_results():
    from pytorch_operator_tpu.workloads import resnet_ab as jax_ab
    from pytorch_operator_tpu.workloads import resnet_bench as jax_resnet

    kw = dict(batch_size=8, image_size=32, classes=10, steps=1, warmup=1, log=lambda m: None)
    return {
        "resnet": jax_resnet.run_benchmark(depth=18, **kw),
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
