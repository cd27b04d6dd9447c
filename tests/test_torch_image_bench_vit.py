"""The port's ViT bench against the JAX package's, on the CPU (moved from
``tests/test_torch_image_bench.py``, one file a bench's runs).

- ``vit_bench``, dense and flash: the JAX result keys (plus the port's
  ``device``, ``peak_mem_bytes`` and ``losses``), losses that fall, the
  file path, the remat-policy refusal.
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from tests.test_torch_image_bench import SMALL, _packed
from pytorch_operator_tpu_torch.workloads import vit_bench


@pytest.fixture(scope="module")
def jax_results():
    from pytorch_operator_tpu.workloads import vit_bench as jax_vit

    kw = dict(batch_size=8, image_size=32, classes=10, steps=1, warmup=1, log=lambda m: None)
    return {"vit": jax_vit.run_benchmark(variant="s16", **kw)}


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
