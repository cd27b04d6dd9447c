"""Gradients of the port's flash attention (pytorch_operator_tpu_torch/ops/
flash_attention.py) against the JAX package's, on the CPU.

On CPU tensors the port's ``FlashAttentionFunction`` runs the plain forward
and :func:`flash_attention_backward_reference` (the backward kernels'
arithmetic, densely) through the same padding and kv_len plan as the
kernels. dq/dk/dv of ``sum(o * w)`` for a fixed numpy ``w`` are held against
``jax.grad`` through the JAX flash kernel in pallas interpret mode and
through ``_dense_reference``, at atol 5e-4 for f32 — the JAX package's own
flash-vs-dense gradient tolerance (tests/test_flash_attention.py). The
CUDA kernels are held against the same plain version on the card by
chip_smoke.py and tests/test_torch_kernels_cuda.py.
"""

import math

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.ops.flash_attention import _dense_reference
from pytorch_operator_tpu.ops.flash_attention import flash_attention as jax_flash
from pytorch_operator_tpu_torch.ops import flash_attention as fa

TOL = 5e-4


def _inputs(seed, B, S, H, KH, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KH, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KH, D), dtype=np.float32)
    w = rng.standard_normal((B, S, H, D), dtype=np.float32)
    return q, k, v, w


def _port_grads(q, k, v, w, dtype=torch.float32, **kw):
    qkv = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = fa.flash_attention(*qkv, **kw)
    grads = torch.autograd.grad((o.float() * torch.from_numpy(w)).sum(), qkv)
    return [g.float().numpy() for g in grads]


def _jax_grads(fn, q, k, v, w, dtype=np.float32):
    import jax
    import jax.numpy as jnp

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(g, np.float32) for g in grads]


def _flash(**kw):
    return lambda q, k, v: jax_flash(q, k, v, interpret=True, **kw)


def _assert_grads(got, ref, atol, what):
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(g, r, atol=atol, rtol=0, err_msg=f"d{name} vs {what}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KH", [(4, 4), (4, 2), (4, 1)], ids=["G1", "G2", "G4"])
def test_grads_match_jax_kernel_and_dense(causal, H, KH):
    q, k, v, w = _inputs(0, 2, 32, H, KH, 16)
    got = _port_grads(q, k, v, w, causal=causal, block_q=16, block_k=16)
    _assert_grads(got, _jax_grads(_flash(causal=causal, block_q=16, block_k=16), q, k, v, w),
                  TOL, "JAX flash")
    dense = lambda q, k, v: _dense_reference(q, k, v, causal=causal)  # noqa: E731
    _assert_grads(got, _jax_grads(dense, q, k, v, w), TOL, "JAX dense")


@pytest.mark.parametrize("causal", [True, False])
def test_padded_seq_grads(causal):
    """S=48 under 32-blocks pads to 64: padded keys masked through kv_len,
    padded rows get a zero output gradient and are sliced off."""
    q, k, v, w = _inputs(3, 1, 48, 2, 2, 8)
    got = _port_grads(q, k, v, w, causal=causal, block_q=32, block_k=32)
    _assert_grads(got, _jax_grads(_flash(causal=causal, block_q=32, block_k=32), q, k, v, w),
                  TOL, "JAX flash")
    dense = lambda q, k, v: _dense_reference(q, k, v, causal=causal)  # noqa: E731
    _assert_grads(got, _jax_grads(dense, q, k, v, w), TOL, "JAX dense")


def _dense_kv_len(q, k, v, *, causal: bool, kv_len: int):
    """``_dense_reference`` with keys at or past ``kv_len`` masked: a query
    row below kv_len sees the (causal) prefix, a later row all kv_len keys."""
    import jax.numpy as jnp

    kk, vv = k[:, :kv_len], v[:, :kv_len]
    head = _dense_reference(q[:, :kv_len], kk, vv, causal=causal)
    tail = _dense_reference(q[:, kv_len:], kk, vv, causal=False)
    return jnp.concatenate([head, tail], axis=1)


# The shapes at which the dkv kernel's walk and tiles meet their edges, small:
# (B, S, H, KH, D, causal, kv_len, block). G 8 is the longest walk over the
# query heads of one kv head; a causal kv_len ends inside a key tile (70) or
# below one 64-key warpgroup's first tile (20); S 192 with 64-blocks is
# S = 64 mod 128, where the kernel's last 128-key tile is half past S.
DKV_EDGE_CASES = {
    "G8_causal": (1, 64, 8, 1, 16, True, None, 16),
    "G8_full": (1, 64, 8, 1, 16, False, None, 16),
    "causal_kv_len70": (1, 96, 4, 2, 16, True, 70, 32),
    "causal_kv_len20": (1, 96, 4, 2, 16, True, 20, 32),
    "S192_causal": (1, 192, 2, 1, 16, True, None, 64),
    "S192_full_kv_len100": (1, 192, 2, 1, 16, False, 100, 64),
}


@pytest.mark.parametrize("case", DKV_EDGE_CASES.values(), ids=DKV_EDGE_CASES.keys())
def test_dkv_edge_grads_match_jax_kernel_and_dense(case):
    """The plain backward, which the card's checks hold the dkv kernel to, at
    the kernel's edge shapes against ``jax.grad`` through the JAX flash
    kernel (``_dkv_kernel`` in interpret mode) and the dense oracle."""
    B, S, H, KH, D, causal, kv_len, block = case
    q, k, v, w = _inputs(12, B, S, H, KH, D)
    kw = dict(causal=causal, kv_len=kv_len, block_q=block, block_k=block)
    got = _port_grads(q, k, v, w, **kw)
    _assert_grads(got, _jax_grads(_flash(**kw), q, k, v, w), TOL, "JAX flash")
    if kv_len is None:
        dense = lambda q, k, v: _dense_reference(q, k, v, causal=causal)  # noqa: E731
    else:
        dense = lambda q, k, v: _dense_kv_len(q, k, v, causal=causal, kv_len=kv_len)  # noqa: E731
        assert np.abs(got[1][:, kv_len:]).max() == 0 and np.abs(got[2][:, kv_len:]).max() == 0
    _assert_grads(got, _jax_grads(dense, q, k, v, w), TOL, "JAX dense")


def test_kv_len_grads():
    """Keys past kv_len get zero dk/dv and add nothing to dq."""
    B, S, H, KH, D, L = 1, 48, 4, 2, 16, 37
    q, k, v, w = _inputs(6, B, S, H, KH, D)
    got = _port_grads(q, k, v, w, causal=False, kv_len=L, block_q=16, block_k=16)
    ref = _jax_grads(_flash(causal=False, kv_len=L, block_q=16, block_k=16), q, k, v, w)
    _assert_grads(got, ref, TOL, "JAX flash")
    assert np.abs(got[1][:, L:]).max() == 0 and np.abs(got[2][:, L:]).max() == 0


def test_head_dim_80_grads():
    """D=80: the CUDA plan pads D to 128 (scale stays 1/sqrt(80)); on the
    CPU the plain path runs at D=80. Both against JAX."""
    q, k, v, w = _inputs(8, 1, 40, 2, 1, 80)
    got = _port_grads(q, k, v, w, block_q=16, block_k=16)
    _assert_grads(got, _jax_grads(_flash(block_q=16, block_k=16), q, k, v, w), TOL, "JAX flash")
    assert fa._plan_tiling(40, 80, 1024, 1024, True)[3] == 128
    # The padded plan on the CPU: zero head columns change nothing.
    B, S, H, D = q.shape
    pad = (0, 128 - D, 0, 0, 0, 64 - S)
    tq, tk, tv, tw = (torch.nn.functional.pad(torch.from_numpy(x), pad) for x in (q, k, v, w))
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal=True, kv_len=S, scale=1 / math.sqrt(D))
    dq, dk, dv = fa.flash_attention_backward_reference(
        tq, tk, tv, o, lse, tw, causal=True, kv_len=S, scale=1 / math.sqrt(D)
    )
    for g, p, name in zip(got, (dq, dk, dv), "qkv"):
        np.testing.assert_allclose(p[:, :S, :, :D].numpy(), g, atol=TOL, err_msg=f"d{name}")
        assert p[:, :, :, D:].abs().max() == 0


def test_bf16_grads_close():
    """bf16 inputs: ds and p are rounded to bf16 before their products on
    both sides, which round in different places; held at a relative L2
    error of 1e-2, over the whole gradient and over its late half, against
    JAX's bf16 kernel and the f32 dense oracle on the same bf16-rounded
    inputs (the readings are 1e-3 to 3.3e-3)."""
    import jax.numpy as jnp

    q, k, v, w = _inputs(5, 1, 64, 4, 2, 16)
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in (q, k, v))
    got = _port_grads(q, k, v, w, dtype=torch.bfloat16, block_q=16, block_k=16)
    for ref, what in (
        (_jax_grads(_flash(block_q=16, block_k=16), q, k, v, w, jnp.bfloat16), "JAX flash bf16"),
        (_jax_grads(lambda q, k, v: _dense_reference(q, k, v, causal=True), q, k, v, w),
         "JAX dense f32"),
    ):
        for g, r, name in zip(got, ref, "qkv"):
            agree = fa.grad_agreement(torch.from_numpy(g), torch.from_numpy(r), 64)
            assert max(agree["rel"], agree["rel_late"]) <= 1e-2, (f"d{name} vs {what}", agree)


@pytest.mark.parametrize("fault", [None, "late_half_zero", "last_tile_zero", "last_row_negated"])
def test_grad_agreement_catches_late_faults(fault):
    """``grad_agreement``, the check that holds the backward kernels to their
    plain version on the card, passes a bf16 rounding of the plain dv and
    fails faults confined to the late keys, whose causal gradients are far
    below the first keys' (a tolerance scaled to max|ref| passes such
    faults at the training shape)."""
    S = 512
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(11, 1, S, 2, 1, 64))
    args = dict(causal=True, kv_len=S, scale=1 / 8)
    o, lse = fa.flash_attention_reference(q, k, v, **args)
    dv = fa.flash_attention_backward_reference(q, k, v, o, lse, w, **args)[2]
    g = dv.to(torch.bfloat16)
    if fault == "late_half_zero":
        g[:, S // 2:] = 0
    elif fault == "last_tile_zero":
        g[:, -64:] = 0
    elif fault == "last_row_negated":
        g[:, -1] = -g[:, -1]
    agree = fa.grad_agreement(g, dv, S)
    assert agree["ok"] == (fault is None), agree


def test_lse_is_not_differentiable_and_counts_stay_zero_on_cpu():
    q, k, v, _ = _inputs(9, 1, 16, 2, 2, 8)
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fa.reset_launch_count()
    o, lse = fa.flash_attention_with_lse(*qkv, block_q=16, block_k=16)
    assert o.requires_grad and not lse.requires_grad
    o.sum().backward()
    assert (fa.launch_count, fa.dq_launch_count, fa.dkv_launch_count) == (0, 0, 0)
