"""The port's mixture-of-experts layer (pytorch_operator_tpu_torch/parallel/
moe.py) against the JAX package's, on the CPU.

Inputs come from a numpy seed; both packages get the same arrays. In f32
both sides compute the same sums in other orders, so outputs are held within
atol 1e-5 of outputs of magnitude ~7 and gradients within atol 1e-6 of
gradients of magnitude ~0.05 (readings ~2e-6 and ~3e-8); the exact GELU in
place of JAX's tanh form moves outputs by ~1e-3 and would fail. Routing
indices and load-balance values are held exactly (rtol 1e-6). A token count
of 1,500 is no multiple of the 1,024 group size, so the sparse path runs
groups of 750. In bf16 the two packages round products and the GELU in
other places, so values are held by relative L2 within 1e-2 (reading
3.6e-3), and the reference's rounding points, ``dispatch`` cast to ``x``'s
dtype and ``combine`` (and the dense gates) to the experts' output dtype
before their products, are held by the dtypes that reach those products.
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pytorch_operator_tpu.parallel import moe as jax_moe
from pytorch_operator_tpu_torch.parallel import moe

ATOL_OUT, ATOL_GRAD = 1e-5, 1e-6
BF16_REL = 1e-2
E, D, F, N = 8, 16, 32, 1500


def _params(e=E, d=D, f=F, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "gate": (rng.standard_normal((d, e)) * 0.5).astype(np.float32),
        "w_in": (rng.standard_normal((e, d, f)) * 0.3).astype(np.float32),
        "w_out": (rng.standard_normal((e, f, d)) * 0.3).astype(np.float32),
    }


def _x(n=N, d=D, seed=1):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _jax(tree):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree, grad=False):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(grad) for k, v in tree.items()}


def test_router_topk_indices_and_ties_match_jax():
    import jax.numpy as jnp

    p, x = _params(), _x()
    _, jidx, jprobs = jax_moe._router_topk(_jax(p), jnp.asarray(x), 3)
    _, idx, probs = moe._router_topk(_torch(p), torch.from_numpy(x), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=5e-7)
    # A planted tie: experts 1, 3 and 6 share one gate column, so each
    # token's logits tie among them; both break it to the lower index.
    gate = p["gate"].copy()
    gate[:, 3] = gate[:, 6] = gate[:, 1]
    tied = dict(p, gate=gate)
    _, jidx, _ = jax_moe._router_topk(_jax(tied), jnp.asarray(x), 4)
    _, idx, _ = moe._router_topk(_torch(tied), torch.from_numpy(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    chosen = idx.numpy()
    for a, b in ((1, 3), (3, 6), (1, 6)):
        rows = (chosen == a).any(1) & (chosen == b).any(1)
        assert rows.any()
        pos = lambda e: np.argmax(chosen[rows] == e, axis=1)  # noqa: E731
        assert (pos(a) < pos(b)).all(), (a, b)


def test_gates_and_load_balance_loss_match_jax():
    import jax.numpy as jnp

    p, x = _params(), _x()
    for k in (1, 2, 8):
        np.testing.assert_allclose(
            moe._gates(_torch(p), torch.from_numpy(x), k).numpy(),
            np.asarray(jax_moe._gates(_jax(p), jnp.asarray(x), k)), rtol=1e-6, atol=1e-7,
        )
        np.testing.assert_allclose(
            float(moe.load_balance_loss(_torch(p), torch.from_numpy(x), k)),
            float(jax_moe.load_balance_loss(_jax(p), jnp.asarray(x), k)), rtol=1e-6,
        )


def test_load_balance_loss_at_balanced_and_collapsed_routing():
    """The reference's values: a zero gate (uniform router) scores ~1.0, a
    router collapsed onto expert 0 scores ~E; the port's equal JAX's."""
    import jax.numpy as jnp

    n, d = 512, 16
    x = np.random.default_rng(5).standard_normal((n, d)).astype(np.float32)
    balanced = {"gate": np.zeros((d, E), np.float32)}
    collapsed = {"gate": np.zeros((d, E), np.float32)}
    collapsed["gate"][0, 0] = 100.0
    for gate, xin, k, lo, hi in ((balanced, x, 2, 0.9, 1.3), (collapsed, np.abs(x), 1, 0.8 * E, E)):
        got = float(moe.load_balance_loss(_torch(gate), torch.from_numpy(xin), k))
        want = float(jax_moe.load_balance_loss(_jax(gate), jnp.asarray(xin), k))
        assert lo < got <= hi + 1e-6, got
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _out_and_grads(fn, p, x):
    tp, tx = _torch(p, grad=True), torch.from_numpy(x).requires_grad_()
    out = fn(tp, tx)
    (out**2).mean().backward()
    return out.detach().numpy(), {**{k: v.grad.numpy() for k, v in tp.items()}, "x": tx.grad.numpy()}


def _jax_out_and_grads(fn, p, x):
    import jax
    import jax.numpy as jnp

    jp, jx = _jax(p), jnp.asarray(x)
    out = fn(jp, jx)
    gp, gx = jax.grad(lambda a, b: (fn(a, b) ** 2).mean(), argnums=(0, 1))(jp, jx)
    return np.asarray(out), {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx)}


CASES = {
    "dense": (jax_moe.moe_mlp_reference, moe.moe_mlp_reference, {}),
    "sparse_ample": (jax_moe.moe_mlp_sparse, moe.moe_mlp_sparse, {"capacity_factor": E / 2}),
    "sparse_tight": (jax_moe.moe_mlp_sparse, moe.moe_mlp_sparse, {"capacity_factor": 1.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("top_k", [1, 2])
def test_outputs_and_gradients_match_jax(case, top_k):
    jfn, pfn, kw = CASES[case]
    p, x = _params(), _x()
    got, gg = _out_and_grads(lambda a, b: pfn(a, b, top_k=top_k, **kw), p, x)
    want, gw = _jax_out_and_grads(lambda a, b: jfn(a, b, top_k=top_k, **kw), p, x)
    assert got.shape == (N, D)
    np.testing.assert_allclose(got, want, atol=ATOL_OUT)
    for name in ("gate", "w_in", "w_out", "x"):
        # Top-1's renormalised probability is 1: no gradient reaches the gate.
        assert (np.abs(gw[name]).max() > 0) == (name != "gate" or top_k > 1), name
        np.testing.assert_allclose(gg[name], gw[name], atol=ATOL_GRAD, err_msg=name)


def test_sparse_at_ample_capacity_equals_dense():
    """capacity_factor E/top_k gives every expert room for a whole group:
    nothing drops, and sparse dispatch computes the dense result."""
    p, x = _torch(_params()), torch.from_numpy(_x())
    dense = moe.moe_mlp_reference(p, x, top_k=2)
    sparse = moe.moe_mlp_sparse(p, x, top_k=2, capacity_factor=E / 2)
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), atol=ATOL_OUT)


def test_sparse_tight_capacity_drops_not_corrupts():
    """At capacity factor 1.0 some (token, choice) pairs drop: each row is
    the dense row or a strict part of it (one choice dropped: the other
    choice's term alone; both: zero), never anything else, and finite."""
    p, x = _torch(_params()), torch.from_numpy(_x(n=32 * 8))
    out = moe.moe_mlp_sparse(p, x, top_k=2, capacity_factor=1.0, group_size=32)
    dense = moe.moe_mlp_reference(p, x, top_k=2)
    _, idx, probs = moe._router_topk(p, x, 2)
    terms = [
        moe._expert_ffn(p["w_in"], p["w_out"], torch.zeros(len(x), E).scatter(-1, idx[:, k : k + 1], probs[:, k : k + 1]), x)
        for k in range(2)
    ]
    candidates = torch.stack([dense, terms[0], terms[1], torch.zeros_like(dense)])  # [4, n, D]
    dist = (out[None] - candidates).abs().amax(-1)  # [4, n]
    assert torch.isfinite(out).all()
    assert (dist.amin(0) <= ATOL_OUT).all(), "a row is neither kept, partly dropped nor dropped"
    kept = dist[0] <= ATOL_OUT
    assert kept.any() and not kept.all(), "nothing dropped, or everything: dispatch broken"
    # Capacity ceil(32 · 1.0 · 2 / 8) = 8: a slot holds at most one token, a
    # token at most top_k slots.
    dispatch, _ = moe._dispatch_tensors(p, x.reshape(8, 32, D), 2, 8)
    assert dispatch.sum(dim=1).amax() == 1 and dispatch.sum(dim=(2, 3)).amax() == 2


class _ProductDtypes(TorchDispatchMode):
    """Records the dtypes of every ``bmm``'s operands."""

    def __init__(self):
        super().__init__()
        self.bmm = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default:
            self.bmm.append((tuple(args[0].shape), args[0].dtype, args[1].dtype))
        return func(*args, **(kwargs or {}))


def test_bf16_rounding_points_and_values():
    """In bf16, the dispatch, combine and dense gate operands reach their
    products rounded to bf16 (not f32 beside a bf16 operand), and the outputs
    agree with JAX's bf16 results by relative L2."""
    import jax.numpy as jnp

    p, x = _params(d=64, f=128), _x(n=512, d=64)
    tp = {"gate": torch.from_numpy(p["gate"]), "w_in": torch.from_numpy(p["w_in"]).bfloat16(),
          "w_out": torch.from_numpy(p["w_out"]).bfloat16()}
    jp = {"gate": jnp.asarray(p["gate"]), "w_in": jnp.asarray(p["w_in"], jnp.bfloat16),
          "w_out": jnp.asarray(p["w_out"], jnp.bfloat16)}
    for name, (jfn, pfn, kw) in sorted(CASES.items()):
        with _ProductDtypes() as seen:
            got = pfn(tp, torch.from_numpy(x).bfloat16(), top_k=2, **kw)
        assert got.dtype == torch.bfloat16
        assert seen.bmm and all(a == b == torch.bfloat16 for _, a, b in seen.bmm), seen.bmm
        want = np.asarray(jfn(jp, jnp.asarray(x, jnp.bfloat16), top_k=2, **kw).astype(jnp.float32))
        rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
        assert rel < BF16_REL, (name, rel)


def test_aux_loss_spreads_the_router():
    """Training the MoE Llama WITH the aux loss ends more balanced than
    without it (the reference's test: tiny, 8 experts, dense attention,
    AdamW 3e-3, 12 steps on one batch), by the load-balance loss of each
    layer's router on its own inputs, the quantity the aux term lowers (mean
    over layers; readings 1.0111 with, 1.0141 without, from 1.0342)."""
    from pytorch_operator_tpu_torch.models import llama
    from pytorch_operator_tpu_torch.workloads import trainer

    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (8, 32))).long()

    def balance(model):
        seen = []

        def hook(mlp, args, out):
            x2d = args[0].reshape(-1, mlp.cfg.d_model)
            seen.append(float(moe.load_balance_loss({"gate": mlp.gate}, x2d, 2)))

        hooks = [layer.moe_mlp.register_forward_hook(hook) for layer in model.layers]
        with torch.no_grad():
            model(tokens)
        for h in hooks:
            h.remove()
        return sum(seen) / len(seen)

    def train(aux_weight):
        cfg = llama.llama_tiny(n_experts=8, attn_impl="dense", moe_aux_weight=aux_weight)
        model = llama.Llama(cfg).init_weights(torch.Generator().manual_seed(0))
        opt = trainer.make_optimizer(model.parameters(), 3e-3, weight_decay=1e-4)
        step = trainer.make_lm_train_step(model, opt)
        for _ in range(12):
            loss = step(tokens)
        assert np.isfinite(float(loss))
        return balance(model)

    with_aux, without = train(0.05), train(0.0)
    assert with_aux < without, (with_aux, without)


def test_mesh_paths_and_bad_top_k_raise():
    """The mesh paths without a world (``mesh=None``) run every expert here,
    as the one-device paths do (over ep they are tests/test_torch_ep.py's);
    a bank that is not the rank's block of E, and a bad top_k, raise."""
    p, x = _torch(_params()), torch.from_numpy(_x())
    torch.testing.assert_close(moe.moe_mlp(p, x, mesh=None), moe.moe_mlp_reference(p, x), rtol=0, atol=0)
    torch.testing.assert_close(moe.moe_mlp_sparse(p, x, mesh=None), moe.moe_mlp_sparse(p, x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="w_in holds 4 experts"):
        moe.moe_mlp(dict(p, w_in=p["w_in"][:4]), x, mesh=None)
    for fn in (moe.moe_mlp_reference, moe.moe_mlp_sparse, lambda p, x, top_k: moe.moe_mlp(p, x, mesh=None, top_k=top_k)):
        for k in (0, E + 1):
            with pytest.raises(ValueError, match="top_k"):
                fn(p, x, top_k=k)
