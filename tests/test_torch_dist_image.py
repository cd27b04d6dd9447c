"""The port's ResNet training step in a world of two processes (gloo, each
rank its half of the global batch, gradients averaged, batch-norm sums
all-reduced) against the JAX package's on a dp mesh of 2 virtual CPU devices
(``resnet_bench``'s own ``build_train_state`` and ``_train_step_fn`` under
``jit``, where XLA reduces the batch-norm statistics over the global batch),
from the same init: a tiny f32 ResNet (stage sizes [1, 1], 8 filters,
32 px), global batch 8, three SGD-nesterov steps.

Held: each step's loss, the final parameters and the running buffers, and
the same run in one process. A planted fault, batch norm per rank (what
plain DDP computes), reads above the limits. The ranks also run
``resnet_bench.run_benchmark`` in the world (ResNet-18, a packed file): the
global batch splits over the ranks and both report the same loss.

Limits (f32; above the readings): losses within rtol ``LOSS_RTOL``
(readings ≤ 1.5e-7), parameters and buffers within ``STATE_ATOL`` (≤ 6e-7
against JAX). Per-rank batch norm reads 4.4e-3 on the losses and 4.4e-2 on
the state.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorch_operator_tpu_torch.models.convert import resnet_params_from_jax
from pytorch_operator_tpu_torch.workloads.datasets import synthetic_images
from tests import torch_worlds

ROOT = Path(__file__).resolve().parents[1]
STEPS, B, HW = 3, 8, 32
LOSS_RTOL = 1e-5
STATE_ATOL = 1e-5

_JAX_RUN = """
import pickle, sys
import tests.jaxenv
import jax, jax.numpy as jnp
from pytorch_operator_tpu.models import resnet
from pytorch_operator_tpu.parallel import make_mesh
from pytorch_operator_tpu.parallel.data import global_batch
from pytorch_operator_tpu.workloads import resnet_bench
assert jax.device_count() == 2, jax.devices()
x, y, steps, out = pickle.load(open(sys.argv[1], "rb"))
model = resnet.ResNet(stage_sizes=[1, 1], num_classes=10, num_filters=8, dtype=jnp.float32)
mesh = make_mesh({"dp": 2})
params, stats, opt_state, tx = resnet_bench.build_train_state(
    model, mesh, lr=0.1, momentum=0.9, seed=0, image_size=x.shape[1])
init = jax.device_get((params, stats))
step = resnet_bench.make_train_step(model, tx)
gx, gy = global_batch(x, mesh), global_batch(y, mesh)
losses = []
for _ in range(steps):
    params, stats, opt_state, loss = step(params, stats, opt_state, gx, gy)
    losses.append(float(loss))
pickle.dump({"init": init, "losses": losses, "final": jax.device_get((params, stats))}, open(out, "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_image")
    x, y = synthetic_images(B, HW, HW, 10, seed=1)
    (d / "in.pkl").write_bytes(pickle.dumps((x, y, STEPS, str(d / "jax.pkl"))))
    env = dict(__import__("os").environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run([sys.executable, "-c", _JAX_RUN, str(d / "in.pkl")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    jax_run = pickle.loads((d / "jax.pkl").read_bytes())
    init = {k: v.numpy() for k, v in resnet_params_from_jax(*jax_run["init"]).items()}
    f = d / "syn.bin"
    from pytorch_operator_tpu_torch.data import pack

    pack.main(["--dataset", "synthetic", "--n", "32", "--height", "32", "--width", "32",
               "--classes", "10", "--out", str(f)])
    bench_kw = dict(depth=18, batch_size=8, classes=10, steps=2, warmup=1, data_file=str(f))
    two = torch_worlds.run_world("resnet", init, x, y, STEPS, True, bench_kw)
    per_rank = torch_worlds.run_world("resnet", init, x, y, STEPS, False)
    one = torch_worlds.rank_resnet(_One(), init, x, y, STEPS, True)
    return {"jax": jax_run, "two": two, "per_rank": per_rank, "one": one}


class _One:
    num_processes, process_id = 1, 0


def _state_gap(state, jax_final) -> float:
    want = resnet_params_from_jax(*jax_final)
    return max(float(np.abs(state[k] - v.numpy()).max()) for k, v in want.items())


def test_two_ranks_match_jax_on_two_devices(runs):
    want = runs["jax"]["losses"]
    for r in runs["two"]:
        np.testing.assert_allclose(r["losses"], want, rtol=LOSS_RTOL)
        assert _state_gap(r["state"], runs["jax"]["final"]) <= STATE_ATOL
    a, b = (r["state"] for r in runs["two"])
    assert all(np.array_equal(a[k], b[k]) for k in a)  # the ranks stay in step


def test_two_ranks_match_one_process(runs):
    np.testing.assert_allclose(runs["two"][0]["losses"], runs["one"]["losses"], rtol=LOSS_RTOL)
    assert _state_gap(runs["one"]["state"], runs["jax"]["final"]) <= STATE_ATOL


def test_planted_per_rank_batch_norm_reads_above_the_limits(runs):
    r = runs["per_rank"][0]
    want = runs["jax"]["losses"]
    loss_gap = max(abs(a / b - 1) for a, b in zip(r["losses"], want))
    assert loss_gap > 10 * LOSS_RTOL, r["losses"]
    assert _state_gap(r["state"], runs["jax"]["final"]) > 10 * STATE_ATOL


def test_run_benchmark_in_a_world(runs):
    """``resnet_bench.run_benchmark`` in the two-rank world on a packed file:
    the global batch over both ranks, one loss, a per-chip rate."""
    results = [r["bench"] for r in runs["two"]]
    for r in results:
        assert (r["devices"], r["global_batch"], r["input"]) == (2, 8, "file")
        assert np.isfinite(r["final_loss"]) and r["value"] > 0
    assert results[0]["losses"] == results[1]["losses"]

