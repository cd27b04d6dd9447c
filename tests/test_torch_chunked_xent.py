"""The port's chunked-vocab cross-entropy (pytorch_operator_tpu_torch/ops/
chunked_xent.py) against the JAX package's and the dense loss, on the CPU.

Same inputs from a numpy seed on both sides; the loss and the gradients of
``sum(loss * c)`` with respect to hidden and w. Tolerances are the JAX
package's own (tests/test_chunked_xent.py): rtol 1e-5 for the loss, 1e-4 for
the gradients (f32 logits on both sides, sums in another order).
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.ops.chunked_xent import chunked_softmax_xent as jax_xent
from pytorch_operator_tpu_torch.ops.chunked_xent import chunked_softmax_xent


def _rand(n, d, v, seed=0, label_lo=0, label_hi=None):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.05).astype(np.float32)
    labels = rng.integers(label_lo, label_hi or v, n).astype(np.int32)
    coef = rng.standard_normal(n).astype(np.float32)
    return hidden, w, labels, coef


def _port(hidden, w, labels, coef, chunk, dtype=torch.float32):
    h = torch.from_numpy(hidden).to(dtype).requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    loss = chunked_softmax_xent(h, ww, torch.from_numpy(labels), chunk=chunk)
    (loss * torch.from_numpy(coef)).sum().backward()
    return loss.detach().numpy(), h.grad.float().numpy(), ww.grad.numpy()


def _jax(hidden, w, labels, coef, chunk=None):
    """The JAX chunked op (``chunk`` given) or the dense loss over clamped
    labels, with its gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    lab = jnp.asarray(labels)

    def loss_fn(h, w):
        if chunk is not None:
            return jax_xent(h, w, lab, chunk=chunk)
        logits = h.astype(jnp.float32) @ w.astype(jnp.float32)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.clip(lab, 0, w.shape[1] - 1)
        )

    def total(h, w):
        return jnp.sum(loss_fn(h, w) * coef)

    gh, gw = jax.grad(total, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(w))
    return (np.asarray(loss_fn(jnp.asarray(hidden), jnp.asarray(w))), np.asarray(gh),
            np.asarray(gw))


def _check(got, ref):
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("chunk", [7, 32, 1000])
def test_matches_jax_and_dense(chunk):
    args = _rand(12, 16, 96)
    got = _port(*args, chunk=chunk)
    _check(got, _jax(*args, chunk=chunk))
    _check(got, _jax(*args))


@pytest.mark.parametrize("v,chunk", [(97, 64), (101, 25), (100, 100)])
def test_non_divisible_vocab(v, chunk):
    """A vocab that does not divide into chunks: the clamped tail chunk with
    its already-counted columns masked, in the loss and in both gradients."""
    args = _rand(9, 8, v, seed=7)
    got = _port(*args, chunk=chunk)
    _check(got, _jax(*args, chunk=chunk))
    _check(got, _jax(*args))


def test_out_of_range_labels_clamp():
    """Labels outside [0, V) clamp to the range edges, as in the JAX op."""
    args = _rand(16, 8, 50, seed=3, label_lo=-20, label_hi=70)
    assert (args[2] < 0).any() and (args[2] >= 50).any()
    got = _port(*args, chunk=16)
    assert np.isfinite(got[0]).all()
    _check(got, _jax(*args, chunk=16))
    _check(got, _jax(*args))


def test_bf16_hidden_keeps_f32_logits():
    """bf16 hidden: logits math is f32, dh comes back in bf16."""
    import jax.numpy as jnp

    hidden, w, labels, coef = _rand(10, 16, 40, seed=4)
    hidden = np.asarray(jnp.asarray(hidden, jnp.bfloat16), np.float32)
    h = torch.from_numpy(hidden).bfloat16().requires_grad_()
    loss = chunked_softmax_xent(h, torch.from_numpy(w), torch.from_numpy(labels), chunk=16)
    assert loss.dtype == torch.float32
    (loss * torch.from_numpy(coef)).sum().backward()
    assert h.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(
        loss.detach().numpy(), _jax(hidden, w, labels, coef)[0], rtol=1e-5, atol=1e-5
    )
