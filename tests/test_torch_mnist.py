"""The port's digit CNN path (``models/mnist.py``, ``workloads/mnist_train.py``,
``datasets.digits``, ``pack --dataset digits``) against the JAX package's, on
the CPU.

- ``datasets.digits``: both splits equal JAX's bit for bit (JAX's reads
  scikit-learn; the port reads its own copy of the data file, whose sha256
  is held); ``pack --dataset digits`` writes JAX's bytes for both splits.
- ``DigitCNN``: logits, loss and every parameter gradient against JAX's on
  the JAX weights carried across (``convert.mnist_params_from_jax``), in
  f32 and bf16; a planted (c, h, w) flatten reads above the f32 limit.
- ``mnist_train.run``: the losses of an epoch of Adam steps from the same
  parameters and batches against ``DigitCNN`` + ``optax.adam`` written as
  ``mnist_train.py:119-130``; the packed file inline and prefetched with
  equal losses; ``main``'s exit code at a low and an unreachable
  ``--target-acc``.

Limits, from readings on the CPU: f32 logits within ``F32_LOGITS_ATOL``
(readings 2.7e-7) and each gradient within ``F32_GRAD_RTOL`` by relative L2
(6.3e-7); bf16 logits ``BF16_LOGITS_ATOL`` (1.2e-7: both frameworks round
the same bf16 program at the same points in the forward) and gradients
``BF16_GRAD_RTOL`` (4.1e-2: the backward's roundings differ); the Adam
steps' bf16 losses within ``TRAIN_LOSS_ATOL`` of JAX's over the 11 steps of
an epoch (readings 8.9e-4 at step 4, 1.1e-2 at step 22).
"""

import hashlib
import re

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from pytorch_operator_tpu.data import pack as jax_pack
from pytorch_operator_tpu.models.mnist import DigitCNN as JaxCNN
from pytorch_operator_tpu.parallel.data import epoch_batches
from pytorch_operator_tpu.workloads import datasets as jax_datasets
from pytorch_operator_tpu_torch.data import pack as port_pack
from pytorch_operator_tpu_torch.models.convert import mnist_params_from_jax
from pytorch_operator_tpu_torch.models.mnist import DigitCNN
from pytorch_operator_tpu_torch.workloads import datasets, mnist_train

F32_LOGITS_ATOL = 1e-5
F32_GRAD_RTOL = 1e-5
BF16_LOGITS_ATOL = 1e-3
BF16_GRAD_RTOL = 0.1
TRAIN_LOSS_ATOL = 0.03
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def train_split():
    return datasets.digits("train")


@pytest.mark.parametrize("split", ["train", "test"])
def test_digits_equal_jax(split):
    got, want = datasets.digits(split), jax_datasets.digits(split)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert len(got[0]) == {"train": 1438, "test": 359}[split]
    assert hashlib.sha256(datasets.DIGITS_FILE.read_bytes()).hexdigest() == datasets.DIGITS_SHA256
    assert not hasattr(datasets, "REFUSED") and not hasattr(port_pack, "REFUSED_DATASETS")
    with pytest.raises(ValueError, match="unknown split"):
        datasets.digits("val")


@pytest.mark.parametrize("split", ["train", "test"])
def test_pack_digits_equals_jax(tmp_path, split):
    args = ["--dataset", "digits", "--split", split]
    assert port_pack.main(args + ["--out", str(tmp_path / "p.bin")]) == 0
    assert jax_pack.main(args + ["--out", str(tmp_path / "j.bin")]) == 0
    for suffix in ("", ".meta.json"):
        assert (tmp_path / f"p.bin{suffix}").read_bytes() == (tmp_path / f"j.bin{suffix}").read_bytes()


def _jax_cnn(dtype):
    model = JaxCNN(dtype=dtype)
    return model, model.init(jax.random.key(0), jnp.zeros((1, 8, 8, 1)))


def _chw_flatten_forward(model, x):
    """The planted fault: the pooled map flattened in (c, h, w) order."""
    dt = model.dtype
    x = x.to(dt).permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, model.Conv_0.weight.to(dt), model.Conv_0.bias.to(dt), padding=1))
    x = F.relu(F.conv2d(x, model.Conv_1.weight.to(dt), model.Conv_1.bias.to(dt), padding=1))
    x = F.max_pool2d(x, 2, 2).reshape(x.shape[0], -1)
    x = F.relu(F.linear(x, model.Dense_0.weight.to(dt), model.Dense_0.bias.to(dt)))
    return F.linear(x.float(), model.Dense_1.weight, model.Dense_1.bias)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_digit_cnn_matches_jax(train_split, dtype):
    jdt, pdt = DTYPES[dtype]
    bx, by = train_split[0][:32], train_split[1][:32]
    model, variables = _jax_cnn(jdt)

    def loss_fn(v):
        logits = model.apply(v, bx)
        return optax.softmax_cross_entropy_with_integer_labels(logits, by).mean(), logits

    (want_loss, want_logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables)
    port = DigitCNN(dtype=pdt)
    port.load_state_dict(mnist_params_from_jax(variables["params"]))
    logits = port(torch.from_numpy(bx))
    loss = F.cross_entropy(logits, torch.from_numpy(by).long())
    loss.backward()
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (32, 10)
    logits_tol = F32_LOGITS_ATOL if dtype == "f32" else BF16_LOGITS_ATOL
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), atol=logits_tol)
    assert abs(float(loss.detach()) - float(want_loss)) <= logits_tol
    want_grads = mnist_params_from_jax(grads["params"])
    assert set(want_grads) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        rel = float((p.grad - want_grads[name]).norm() / want_grads[name].norm())
        assert rel <= (F32_GRAD_RTOL if dtype == "f32" else BF16_GRAD_RTOL), (name, rel)
    if dtype == "f32":
        with torch.no_grad():
            fault = _chw_flatten_forward(port, torch.from_numpy(bx)).numpy()
        assert np.abs(fault - np.asarray(want_logits)).max() > 100 * F32_LOGITS_ATOL


def test_adam_epoch_follows_jax(train_split):
    """An epoch of ``mnist_train.run`` (B128, 11 steps, bf16) from JAX's
    initial parameters against the JAX workload's step on the same batches
    (``epoch_batches`` with seed ``seed + epoch``)."""
    x, y = train_split
    model, params = _jax_cnn(jnp.bfloat16)
    tx = optax.adam(2e-3)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, opt_state, bx, by):
        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(model.apply(p, bx), by).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    init = mnist_params_from_jax(params["params"])
    want = []
    for bx, by in epoch_batches(x, y, 128, seed=0):
        params, opt_state, loss = train_step(params, opt_state, bx, by)
        want.append(float(loss))
    r = mnist_train.run(epochs=1, device="cpu", init_params=init, log=lambda m: None)
    assert (r["steps"], r["global_batch"], r["devices"], r["device"]) == (11, 128, 1, "cpu")
    np.testing.assert_allclose(r["losses"], want, atol=TRAIN_LOSS_ATOL)
    assert r["losses"][-1] < r["losses"][0] and 0.0 <= r["test_accuracy"] <= 1.0


def test_data_file_inline_equals_prefetched(tmp_path):
    f = tmp_path / "digits.bin"
    assert port_pack.main(["--dataset", "digits", "--out", str(f)]) == 0
    runs = [mnist_train.run(epochs=1, batch_size=256, data_file=str(f), prefetch=p, device="cpu",
                            log=lambda m: None) for p in (0, 2)]
    assert runs[0]["steps"] == 1438 // 256 and runs[0]["losses"] == runs[1]["losses"]
    assert runs[0]["test_accuracy"] == runs[1]["test_accuracy"]


@pytest.mark.parametrize("target,code", [("0.5", 0), ("1.01", 1)])
def test_main_exit_code_follows_target(capsys, target, code):
    assert mnist_train.main(["--epochs", "1", "--target-acc", target, "--device", "cpu"]) == code
    m = re.search(r"test_accuracy=([0-9.]+) \(target ([0-9.]+)\)", capsys.readouterr().out)
    assert m and 0.5 <= float(m.group(1)) < 1.01 and m.group(2) == target
