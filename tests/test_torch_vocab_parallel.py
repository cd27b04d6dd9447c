"""The port's ``chunked_vocab_stats`` and the vocab-parallel loss built on
it (``ops/chunked_xent.py``) against the JAX package's
``chunked_vocab_stats`` and ``chunked_softmax_xent``, in f32 on the CPU.

- The stats ``(m, s, lab_logit)`` of a block of head columns at several
  ``col_offset``s, a block that does not divide into chunks included,
  within rtol 1e-5 (atol 1e-6 near zero).
- ``vocab_parallel_xent`` in a world of two ranks (``tp=2`` over gloo, each
  rank its half of the columns): the per-token loss, hidden's gradient
  (summed over tp by ``tp_enter``) and each rank's block of the head's
  gradient against ``jax.vjp`` of ``chunked_softmax_xent`` on the whole
  head, at the same tolerance; the blocks do not divide into chunks and
  some labels lie outside the vocabulary (both clamp them).
- The planted fault: the ranks' ``s`` summed without the shift by
  ``exp(m - M)``, which reads far above the tolerance.
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.ops import chunked_xent as jax_xent
from pytorch_operator_tpu_torch.ops import chunked_xent
from tests import torch_worlds

N, D, V = 24, 16, 200
RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.8).astype(np.float32)  # logits of std ~3
    labels = rng.integers(0, V, size=N).astype(np.int64)
    labels[:2] = (-3, V + 5)  # clamped to 0 and V - 1
    ct = rng.normal(size=N).astype(np.float32)
    return h, w, labels, ct


@pytest.mark.parametrize("col_offset,cols,chunk", [(0, 200, 64), (37, 100, 32), (100, 100, 100), (150, 50, 7)])
def test_chunked_vocab_stats_match_jax(col_offset, cols, chunk):
    h, w, labels, _ = _inputs()
    labels = np.clip(labels, 0, V - 1)
    wb = w[:, col_offset:col_offset + cols]
    want = jax_xent.chunked_vocab_stats(h, wb, labels.astype(np.int32), chunk=chunk, col_offset=col_offset)
    got = chunked_xent.chunked_vocab_stats(
        torch.from_numpy(h), torch.from_numpy(wb), torch.from_numpy(labels), chunk=chunk,
        col_offset=col_offset,
    )
    for name, g, j in zip(("m", "s", "lab_logit"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL, err_msg=name)
    # The label's logit only where its id falls in the block.
    inside = (labels >= col_offset) & (labels < col_offset + cols)
    assert np.all(got[2].numpy()[~inside] == 0) and inside.any()


@pytest.fixture(scope="module")
def world():
    h, w, labels, ct = _inputs()
    ranks = torch_worlds.run_world("vocab_parallel", h, w, labels, ct, 32, [None, "unshifted_vocab_sum"])
    return (h, w, labels, ct), ranks


def _jax_whole(h, w, labels, ct):
    import jax

    loss, vjp = jax.vjp(lambda a, b: jax_xent.chunked_softmax_xent(a, b, labels, chunk=64), h, w)
    dh, dw = vjp(ct)
    return np.asarray(loss), np.asarray(dh), np.asarray(dw)


def test_vocab_parallel_loss_and_gradients_match_the_whole_head(world):
    (h, w, labels, ct), ranks = world
    loss, dh, dw = _jax_whole(h, w, labels, ct)
    for r in ranks:
        got = r[None]
        np.testing.assert_allclose(got["loss"], loss, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["dh"], dh, rtol=RTOL, atol=ATOL)
        cols = slice(got["start"], got["start"] + got["dw"].shape[1])
        np.testing.assert_allclose(got["dw"], dw[:, cols], rtol=RTOL, atol=ATOL)
    assert [r[None]["start"] for r in ranks] == [0, V // 2]
    # Equal to the port's own whole-head loss too.
    whole = chunked_xent.chunked_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                                              torch.from_numpy(labels), chunk=64)
    np.testing.assert_allclose(ranks[0][None]["loss"], whole.numpy(), rtol=RTOL, atol=ATOL)


def test_planted_unshifted_sum_breaks_the_loss(world):
    (h, w, labels, ct), ranks = world
    loss, _, _ = _jax_whole(h, w, labels, ct)
    sound = float(np.abs(ranks[0][None]["loss"] - loss).max())
    fault = float(np.abs(ranks[0]["unshifted_vocab_sum"]["loss"] - loss).max())
    print(f"unshifted sum: loss {fault:.3e} from JAX's (sound {sound:.3e})")
    assert sound <= RTOL * np.abs(loss).max() + ATOL < 100 * (RTOL * np.abs(loss).max() + ATOL) < fault
