"""The port's flash attention (pytorch_operator_tpu_torch/ops/flash_attention.py)
against the JAX package's kernel in pallas interpret mode and its dense
oracle, on the CPU.

On a CPU tensor the port's wrapper runs its plain version (a dense masked
softmax with the kernel's arithmetic) through the same padding and kv_len
plan as the kernel would, so these cases hold the wrapper's layout, GQA head
mapping, padding and masking, and the lse it returns. The CUDA kernel itself
is held against the same plain version on the card by chip_smoke.py and by
tests/test_torch_kernels_cuda.py.

Tolerances are the JAX package's own (tests/test_flash_attention.py): 2e-5
for f32 (the same math summed in another order), 3e-2 for bf16 (bf16 inputs
and p cast to bf16 before p·v, held against an f32 oracle).
"""

import math

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.ops.flash_attention import _dense_reference
from pytorch_operator_tpu.ops.flash_attention import flash_attention as jax_flash
from pytorch_operator_tpu_torch.ops import flash_attention as fa


def _qkv(seed, B, S, H, KH, D):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, S, H, D), dtype=np.float32),
        rng.standard_normal((B, S, KH, D), dtype=np.float32),
        rng.standard_normal((B, S, KH, D), dtype=np.float32),
    )


def _port(q, k, v, dtype=torch.float32, **kw):
    o, lse = fa.flash_attention_with_lse(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), **kw
    )
    return o.float().numpy(), lse.numpy()


def _jax(q, k, v, dtype=np.float32, **kw):
    import jax.numpy as jnp

    out = jax_flash(*(jnp.asarray(x, dtype) for x in (q, k, v)), interpret=True, **kw)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KH", [(4, 4), (4, 2), (4, 1)])
def test_forward_matches_jax_kernel_and_dense(causal, H, KH):
    q, k, v = _qkv(0, 2, 32, H, KH, 16)
    out, _ = _port(q, k, v, causal=causal, block_q=16, block_k=16)
    np.testing.assert_allclose(
        out, _jax(q, k, v, causal=causal, block_q=16, block_k=16), atol=2e-5
    )
    np.testing.assert_allclose(
        out, np.asarray(_dense_reference(q, k, v, causal=causal)), atol=2e-5
    )


@pytest.mark.parametrize("causal", [True, False])
def test_unaligned_seq_pads_and_masks(causal):
    """S=50 under 32-blocks pads to 64: padded keys masked, rows sliced."""
    q, k, v = _qkv(3, 1, 50, 2, 2, 16)
    out, lse = _port(q, k, v, causal=causal, block_q=32, block_k=32)
    assert out.shape == (1, 50, 2, 16) and lse.shape == (2, 50)
    np.testing.assert_allclose(
        out, _jax(q, k, v, causal=causal, block_q=32, block_k=32), atol=2e-5
    )
    np.testing.assert_allclose(
        out, np.asarray(_dense_reference(q, k, v, causal=causal)), atol=2e-5
    )


def test_kv_len_masks_tail_keys():
    """Keys at positions >= kv_len do not contribute: equals dense attention
    over the first kv_len keys, and the JAX kernel under the same kv_len."""
    B, S, H, KH, D, L = 1, 48, 2, 2, 16, 37
    q, k, v = _qkv(6, B, S, H, KH, D)
    out, _ = _port(q, k, v, causal=False, kv_len=L, block_q=16, block_k=16)
    s = np.einsum("bshd,bthd->bhst", q, k[:, :L]) / math.sqrt(D)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref = np.einsum("bhst,bthd->bshd", p, v[:, :L])
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(
        out, _jax(q, k, v, causal=False, kv_len=L, block_q=16, block_k=16), atol=2e-5
    )


@pytest.mark.parametrize("bq,bk", [(32, 16), (16, 32), (24, 16)])
def test_uneven_blocks(bq, bk):
    """block_q != block_k: the padding plan (24/16 collapses to 16) and the
    causal diagonal agree with the JAX kernel under the same blocks."""
    q, k, v = _qkv(1, 1, 64, 2, 2, 8)
    out, _ = _port(q, k, v, block_q=bq, block_k=bk)
    ref = np.asarray(_dense_reference(q, k, v, causal=True))
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(out, _jax(q, k, v, block_q=bq, block_k=bk), atol=2e-5)


def test_bf16_forward_close():
    import jax.numpy as jnp

    q, k, v = _qkv(5, 1, 64, 4, 2, 16)
    # Round the inputs to bf16 once so both sides see the same values.
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in (q, k, v))
    o, _ = fa.flash_attention_with_lse(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), block_q=16, block_k=16
    )
    assert o.dtype == torch.bfloat16
    out = o.float().numpy()
    np.testing.assert_allclose(
        out, np.asarray(_dense_reference(q, k, v, causal=True)), atol=3e-2
    )
    np.testing.assert_allclose(
        out, _jax(q, k, v, jnp.bfloat16, block_q=16, block_k=16), atol=3e-2
    )


@pytest.mark.parametrize("fault", [None, "late_diagonal_tile_dropped", "late_lse_shifted"])
def test_forward_agreement_catches_late_faults(fault):
    """``forward_agreement``, the check that holds the forward kernel to its
    plain version on the card, passes a bf16 rounding of the plain o and
    fails a forward that drops the diagonal 64-key tile's p·v of the late
    rows (l still summed over it, so lse is unchanged), or whose late lse is
    off by 0.05."""
    B, S, H, D = 1, 1024, 2, 64
    q, k, v = (torch.from_numpy(x) for x in _qkv(13, B, S, H, H, D))
    args = dict(causal=True, kv_len=S, scale=1 / math.sqrt(D))
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, **args)
    o, lse = o_ref.to(torch.bfloat16), lse_ref.clone()
    if fault == "late_diagonal_tile_dropped":
        s = torch.einsum("bshd,bthd->bhst", q, k) * args["scale"]
        p = torch.exp(s - lse_ref.reshape(B, H, S, 1))  # normalised; masked scores
        rows, cols = torch.arange(S)[:, None], torch.arange(S)[None, :]
        p = p.masked_fill(cols > rows, 0.0)  # the causal mask
        p = p.masked_fill((rows >= S // 2) & (cols // 64 == rows // 64), 0.0)
        o = torch.einsum("bhst,bthd->bshd", p, v).to(torch.bfloat16)
    elif fault == "late_lse_shifted":
        lse[:, S - 1] += 0.05
    agree = fa.forward_agreement(o, lse, o_ref, lse_ref, S)
    assert agree["ok"] == (fault is None), agree


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 40), (True, 45)])
def test_lse_matches_dense_logsumexp(causal, kv_len):
    """lse [B*H, S] = log-sum-exp over the unmasked scores of each row,
    computed with JAX from the dense scores (GQA H=4, KH=2)."""
    import jax.numpy as jnp
    from jax.scipy.special import logsumexp

    B, S, H, KH, D = 2, 48, 4, 2, 16
    q, k, v = _qkv(7, B, S, H, KH, D)
    _, lse = _port(q, k, v, causal=causal, kv_len=kv_len, block_q=16, block_k=16)
    kk = jnp.repeat(jnp.asarray(k), H // KH, axis=2)
    s = jnp.einsum("bshd,bthd->bhst", jnp.asarray(q), kk) / math.sqrt(D)
    keep = jnp.arange(S)[None, :] < (kv_len or S)
    if causal:
        keep = keep & (jnp.arange(S)[None, :] <= jnp.arange(S)[:, None])
    ref = logsumexp(jnp.where(keep, s, -jnp.inf), axis=-1).reshape(B * H, S)
    np.testing.assert_allclose(lse, np.asarray(ref), atol=2e-5)


def test_cuda_tiling_plan():
    """The kernel's padding plan (pure arithmetic): S padded to a multiple of
    64, head dims padded to 64 or 128, wider heads refused."""
    plan = fa._plan_tiling
    assert plan(512, 128, 1024, 1024, True) == (64, 64, 512, 128)
    assert plan(500, 128, 1024, 1024, True) == (64, 64, 512, 128)
    assert plan(197, 64, 1024, 1024, True) == (64, 64, 256, 64)
    assert plan(100, 80, 16, 16, True) == (64, 64, 128, 128)
    assert plan(17, 16, 1024, 1024, True) == (64, 64, 64, 64)
    with pytest.raises(ValueError, match="head dim"):
        plan(64, 256, 64, 64, True)
    # The CPU plan mirrors the JAX wrapper's interpret-mode plan.
    from pytorch_operator_tpu.ops.flash_attention import _plan_tiling as jax_plan

    for args in [(48, 8, 32, 32), (17, 8, 1024, 1024), (64, 8, 24, 16), (100, 16, 64, 64)]:
        assert plan(*args, False) == jax_plan(*args, True)
