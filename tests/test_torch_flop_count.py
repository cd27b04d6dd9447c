"""The port's FLOP counter (pytorch_operator_tpu_torch/ops/flop_count.py)
against the JAX package's ``count_flops``, on the CPU.

The port runs ``fn`` on meta tensors under a dispatch mode; JAX walks the
jaxpr. The same computations must count the same: matmul terms exactly
(the flash calls included, counted by their ``pallas_call`` rule), the
flash calls exactly by every primitive, remat's recomputation, the mesh
total, convolutions, and a whole tiny Llama training step's total within
``STEP_TOTAL_RTOL`` (the elementwise ops outside the kernels are written
differently in the two frameworks: a cross-entropy, an RMSNorm, rope).
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch
import torch.nn.functional as F

from pytorch_operator_tpu.ops.flop_count import count_flops as jax_count
from pytorch_operator_tpu_torch.ops import flash_attention as fa
from pytorch_operator_tpu_torch.ops.flop_count import count_flops

# A tiny Llama step's total: measured 0.21% apart (the elementwise terms
# outside the matmuls and kernels), with and without remat.
STEP_TOTAL_RTOL = 0.01


def _leaf(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta", requires_grad=True)


def test_dot_general():
    import jax.numpy as jnp

    fc = count_flops(lambda a, b: a @ b, torch.zeros(8, 16), torch.zeros(16, 4))
    want = jax_count(lambda a, b: a @ b, jnp.zeros((8, 16)), jnp.zeros((16, 4)))
    assert fc.by_primitive["dot_general"] == want.by_primitive["dot_general"] == 2 * 8 * 4 * 16
    # Nothing ran: a real tensor argument was counted as a meta one.
    assert fc.total == 2 * 8 * 4 * 16


def test_remat_backward_counts_recompute():
    """grad of a checkpointed fn recomputes the forward: fwd + recompute +
    2x bwd = 4 matmul units, against 3 without remat, as in JAX."""
    import jax
    import jax.numpy as jnp
    from torch.utils.checkpoint import checkpoint

    unit = 2 * 4 * 16 * 16

    def port(remat):
        def f(w, x):
            g = lambda a: torch.tanh(a @ w).sum()  # noqa: E731
            y = checkpoint(g, x, use_reentrant=False) if remat else g(x)
            y.backward()

        return count_flops(f, _leaf(16, 16), _leaf(4, 16)).by_primitive["dot_general"]

    def ref(remat):
        def f(w, x):
            g = lambda a: jnp.tanh(a @ w).sum()  # noqa: E731
            return (jax.checkpoint(g) if remat else g)(x)

        return jax_count(jax.grad(f, argnums=(0, 1)), jnp.zeros((16, 16)), jnp.zeros((4, 16))) \
            .by_primitive["dot_general"]

    assert port(False) == ref(False) == 3 * unit
    assert port(True) == ref(True) == 4 * unit


def test_mesh_total_runs_every_coordinate():
    """JAX multiplies a shard_map body by its devices; the port runs the
    per-rank program at each coordinate and sums (each rank its slice of a
    stacked weight), and a collective is communication, not FLOPs."""
    from pytorch_operator_tpu_torch.parallel.collectives import axis_index, psum

    seen = []

    def f(w, x):
        i = axis_index("pp")
        seen.append(i)
        return psum(x @ w[i], "pp")

    fc = count_flops(f, torch.zeros(4, 16, 8), torch.zeros(2, 16), axes={"pp": 4})
    assert seen == [0, 1, 2, 3]
    assert fc.by_primitive["dot_general"] == 4 * 2 * 2 * 8 * 16
    assert "psum" not in fc.by_primitive


@pytest.mark.parametrize("pad,stride,groups", [(0, 1, 1), (1, 1, 1), (0, 1, 2), (1, 2, 1)])
def test_convolution_and_its_gradients_match_jax(pad, stride, groups):
    import jax

    N, C, H, W, O, k = 2, 4, 9, 9, 6, 3

    def ref(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (stride, stride), "VALID" if pad == 0 else "SAME", feature_group_count=groups
        ).sum()

    x, w = np.zeros((N, C, H, W), np.float32), np.zeros((O, C // groups, k, k), np.float32)

    def conv(x, w):
        return F.conv2d(x, w, stride=stride, padding=pad, groups=groups)

    fwd = count_flops(conv, _leaf(N, C, H, W), _leaf(O, C // groups, k, k))
    both = count_flops(lambda x, w: conv(x, w).sum().backward(), _leaf(N, C, H, W),
                       _leaf(O, C // groups, k, k))
    key = "conv_general_dilated"
    assert fwd.by_primitive[key] == jax_count(ref, x, w).by_primitive[key]
    assert both.by_primitive[key] == jax_count(jax.grad(ref, argnums=(0, 1)), x, w).by_primitive[key]


FLASH_CASES = [
    # B, S, H, KH, D, causal, block, kv_len
    (1, 16, 2, 1, 8, True, 1024, None),
    (2, 32, 4, 2, 8, True, 16, None),
    (1, 24, 2, 1, 8, True, 16, None),  # S padded to the block: kv_len mask
    (1, 32, 2, 2, 16, False, 8, None),
    (1, 30, 4, 2, 8, True, 16, 20),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_calls_count_the_pallas_rule_exactly(case, monkeypatch):
    """One flash forward and backward: the port's meta call counts JAX's
    three ``pallas_call`` bodies times their grids (and the delta and G sums
    around them) primitive by primitive, launches no kernel and runs no
    plain version."""
    import jax
    import jax.numpy as jnp

    from pytorch_operator_tpu.ops.flash_attention import flash_attention as jax_flash

    B, S, H, KH, D, causal, blk, kv_len = case

    def plain(*a, **kw):
        raise AssertionError("the count ran the plain version")

    monkeypatch.setattr(fa, "flash_attention_reference", plain)
    monkeypatch.setattr(fa, "flash_attention_backward_reference", plain)
    launches = fa.launch_counts()
    kw = dict(causal=causal, block_q=blk, block_k=blk, kv_len=kv_len)

    def port(q, k, v):
        fa.flash_attention(q, k, v, **kw).sum().backward()

    got = count_flops(port, _leaf(B, S, H, D), _leaf(B, S, KH, D), _leaf(B, S, KH, D))
    grad = jax.grad(lambda q, k, v: jax_flash(q, k, v, **kw).sum(), argnums=(0, 1, 2))
    want = jax_count(grad, jnp.zeros((B, S, H, D)), jnp.zeros((B, S, KH, D)), jnp.zeros((B, S, KH, D)))
    assert got.by_primitive == {k: v for k, v in want.by_primitive.items() if v}
    assert got.total == want.total
    assert set(got.by_kernel) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    assert fa.launch_counts() == launches


def _llama_counts(remat: bool):
    import jax
    import jax.numpy as jnp
    import optax

    from pytorch_operator_tpu.models import llama as jax_llama
    from pytorch_operator_tpu_torch.models import llama as port_llama

    over = dict(attn_impl="flash", remat=remat, remat_policy="full")
    jcfg, cfg = jax_llama.llama_tiny(**over), port_llama.llama_tiny(**over)
    B, S = 2, 32
    tokens = jnp.zeros((B, S), jnp.int32)
    jmodel = jax_llama.Llama(jcfg)
    params = jmodel.init(jax.random.key(0), tokens[:1])["params"]

    def loss(p, t):
        logits = jmodel.apply({"params": p}, t)
        return optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1], t[:, 1:]).mean()

    want = jax_count(jax.value_and_grad(loss), params, tokens)
    model = port_llama.Llama(cfg, device="meta")

    def step(t):
        logits = model(t)
        F.cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size), t[:, 1:].reshape(-1)).backward()

    got = count_flops(step, torch.zeros(B, S, dtype=torch.long))
    return got, want, cfg, B, S


@pytest.mark.parametrize("remat", [False, True])
def test_llama_step_matches_jax(remat):
    got, want, cfg, B, S = _llama_counts(remat)
    assert got.by_primitive["dot_general"] == want.by_primitive["dot_general"]
    assert got.total == pytest.approx(want.total, rel=STEP_TOTAL_RTOL)
    # The flash calls: one forward a layer (two under remat: the
    # recomputation) and one of each backward kernel a layer.
    fwd = fa.kernel_flops("flash_fwd", B=B, H=cfg.n_heads, KH=cfg.n_kv_heads, S=S, D=cfg.head_dim,
                          block_q=S, block_k=S, causal=True, kv_masked=False)
    assert got.by_kernel["flash_fwd"] == (1 + remat) * cfg.n_layers * sum(fwd.values())
    # Every matmul term the layers' projections and the head make, plus the
    # flash dots: the count is the model's arithmetic, not a guess.
    D, H, K, hd, Fd, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                          cfg.vocab_size)
    per_layer = 2 * B * S * D * (H * hd + 2 * K * hd) + 2 * B * S * H * hd * D + 3 * 2 * B * S * D * Fd
    # Remat recomputes a layer's forward but its last product (down_proj),
    # whose output no gradient reads: JAX's remat drops it as dead code and
    # torch's checkpoint stops before it.
    recompute = per_layer - 2 * B * S * Fd * D
    attn = (1 + remat) * 4 + 6 + 8  # B·H·S²·hd units: fwd (again under remat), dq, dkv
    want_dots = cfg.n_layers * (3 * per_layer + remat * recompute) + 3 * 2 * B * S * D * V \
        + cfg.n_layers * attn * B * H * S * S * hd
    assert got.by_primitive["dot_general"] == want_dots


def test_1f1b_total_flops_within_1p15_of_gpipe():
    """The pipeline guard of the JAX file on the port's pipeline: a fat
    head (vocab-dominant, its columns chunked over pp), 4 stages, 16
    microbatches. 1F1B (stored residuals) must stay within 1.15x of GPipe
    and both within 1.20x of the stages and head run in one process; a
    P-fold tail or a recomputing backward lands above. The counter sums the
    four stages' programs (``axes={"pp": 4}``)."""
    from pytorch_operator_tpu_torch.parallel.pipeline import pipeline_value_and_grad
    from tests.torch_worlds import _sharded_toy_loss, _toy_stage

    P, M, B, Dm, V = 4, 16, 64, 64, 4096

    def run(schedule, backward="stored"):
        def f(w, b, head, x, tgt):
            pipeline_value_and_grad(
                _toy_stage, _sharded_toy_loss(V // P, None), {"w": w, "b": b}, {"head": head}, x,
                tgt, mesh=None, microbatches=M, schedule=schedule, sharded_loss=True,
                backward=backward,
            )

        # Each stage's slice (a leading axis of 1: the slice a device sees).
        return count_flops(f, _leaf(1, Dm, Dm), _leaf(1, Dm), _leaf(1, Dm, V // P),
                           torch.empty(B, Dm, device="meta"), torch.empty(B, V, device="meta"),
                           axes={"pp": P}).total

    def sequential(w, b, head, x, tgt):
        y = x
        for s in range(P):
            y = _toy_stage({"w": w[s], "b": b[s]}, y)
        ((y @ head - tgt) ** 2).mean().backward()

    f_seq = count_flops(sequential, _leaf(P, Dm, Dm), _leaf(P, Dm), _leaf(Dm, V),
                        torch.empty(B, Dm, device="meta"), torch.empty(B, V, device="meta")).total
    f_gp, f_1f1b, f_re = run("gpipe"), run("1f1b"), run("1f1b", "recompute")
    assert f_1f1b <= 1.15 * f_gp, (f_1f1b, f_gp)
    assert f_1f1b <= 1.20 * f_seq, (f_1f1b, f_seq)
    assert f_gp <= 1.10 * f_seq, (f_gp, f_seq)
    # The recomputing backward reruns each stage's forward: the counter sees it.
    assert f_re > f_1f1b
