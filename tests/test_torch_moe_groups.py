"""Sparse MoE dispatch over token groups that cross ranks
(``parallel/moe.py``: ``moe_mlp_sparse(tokens=)``, ``global_token_index``)
against the JAX package's ``moe_mlp_sparse`` on the global tokens.

The reference groups the global ``[B·S]`` tokens row-major and fills each
group's slots choice-major, so which routings a tight capacity drops
depends on tokens that other ranks hold. The port's ranks each route their
own tokens and gather only the expert indices.

- The layer in two-rank gloo worlds: ``fsdp=2`` (each rank two of the four
  rows) and ``sp=2`` (each rank a block of 16 of every row of 32, the
  group interleaving the ranks' blocks), at capacity factor 0.5 (about half
  the routings dropped) and 4.0 (none), in one group of 128 and, over sp,
  in four groups of 32 each split between the ranks; in a four-rank world
  ``dp=2,ep=2`` against JAX's on ``ep=2``. The output within atol 1e-5 and
  the gradients of x's rows, of the router and of the banks (summed over
  the ranks that share them) within atol 1e-6, ``tests/test_torch_moe.py``'s
  ``ATOL_OUT, ATOL_GRAD``.
- A layout whose groups lie whole on each rank gives what the rank's own
  grouping gives, bit for bit, with no all-gather; the planted fault (each
  rank grouping its own tokens, the parent's dispatch) reads above 1e-2 at
  capacity 0.5.
- ``global_token_index`` against a numpy layout of the reference's
  microbatches and the port's feed (``parallel/data.global_batch``) for
  several (rows, S, data extent, sp, grad_accum); ``count_collectives``
  records the gather as ``all_gather``, one a token axis, of int8 indices.
"""

import itertools

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu_torch.ops.flop_count import count_collectives
from pytorch_operator_tpu_torch.parallel import data as data_lib
from pytorch_operator_tpu_torch.parallel import moe
from tests import torch_worlds

ATOL_OUT, ATOL_GRAD = 1e-5, 1e-6
E, D, F, B, S = 4, 16, 32, 4, 32
PLANT_MIN = 1e-2
TWO = {
    "fsdp2_cf0.5": dict(spec="fsdp=2", capacity_factor=0.5, group_size=1024),
    "fsdp2_cf4": dict(spec="fsdp=2", capacity_factor=4.0, group_size=1024),
    "sp2_cf0.5": dict(spec="sp=2", capacity_factor=0.5, group_size=1024),
    "sp2_cf4": dict(spec="sp=2", capacity_factor=4.0, group_size=1024),
    "sp2_groups32_cf0.5": dict(spec="sp=2", capacity_factor=0.5, group_size=32),
    # Each rank's two rows are two whole groups of 32: the rank's own grouping.
    "fsdp2_whole": dict(spec="fsdp=2", capacity_factor=0.5, group_size=64),
    "fsdp2_whole_own": dict(spec="fsdp=2", capacity_factor=0.5, group_size=64, plant="rank_groups"),
    "planted": dict(spec="fsdp=2", capacity_factor=0.5, group_size=1024, plant="rank_groups"),
}
FOUR = {"dp2_ep2_cf0.5": dict(spec="dp=2,ep=2", capacity_factor=0.5, group_size=1024)}


def _inputs():
    rng = np.random.default_rng(0)
    params = {
        "gate": (rng.standard_normal((D, E)) * 0.5).astype(np.float32),
        "w_in": (rng.standard_normal((E, D, F)) * 0.3).astype(np.float32),
        "w_out": (rng.standard_normal((E, F, D)) * 0.3).astype(np.float32),
    }
    return params, rng.standard_normal((B, S, D)).astype(np.float32)


def _jax(case: dict):
    """JAX's output [B, S, D] and gradients of mean(out²) on the global x."""
    import jax
    import jax.numpy as jnp

    from pytorch_operator_tpu.parallel import make_mesh
    from pytorch_operator_tpu.parallel import moe as jax_moe

    params, x = _inputs()
    mesh = make_mesh("ep=2", devices=jax.devices()[:2]) if "ep" in case["spec"] else None

    def f(p, x):
        return jax_moe.moe_mlp_sparse(p, x, top_k=2, capacity_factor=case["capacity_factor"],
                                      group_size=case["group_size"], mesh=mesh)

    p, x2 = {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x.reshape(-1, D))
    out = jax.jit(f)(p, x2)
    gp, gx = jax.jit(jax.grad(lambda p, x: (f(p, x) ** 2).mean(), argnums=(0, 1)))(p, x2)
    return (np.asarray(out).reshape(B, S, D), {k: np.asarray(v) for k, v in gp.items()},
            np.asarray(gx).reshape(B, S, D))


@pytest.fixture(scope="module")
def worlds():
    params, x = _inputs()

    def cases(table):
        return [dict(c, params=params, x=x) for c in table.values()]

    two = torch_worlds.run_world("moe_groups", cases(TWO))
    four = torch_worlds.run_world("moe_groups", cases(FOUR), n=4)
    out = {name: [r[i] for r in two] for i, name in enumerate(TWO)}
    out.update({name: [r[i] for r in four] for i, name in enumerate(FOUR)})
    return out


def _mine(r, a):
    """This rank's tokens of a global [B, S, ...] array, in its order."""
    (r0, rows), (s0, n) = r["rows"], r["block"]
    return a[r0:r0 + rows, s0:s0 + n].reshape(rows * n, *a.shape[2:])


def _errors(ranks, want_out, want_grads, want_x) -> dict:
    """The largest absolute error of each of the output, x's gradient, the
    router's and the banks' (each summed over the ranks whose tokens it
    holds: the ep ranks of one data coordinate hold the same router
    gradient, each of its experts' bank gradients)."""
    err = {"out": 0.0, "x": 0.0}
    for r in ranks:
        err["out"] = max(err["out"], float(np.abs(r["out"] - _mine(r, want_out)).max()))
        err["x"] = max(err["x"], float(np.abs(r["x"] - _mine(r, want_x)).max()))
    tokens = {(r["rows"], r["block"]): r["gate"] for r in ranks}
    err["gate"] = float(np.abs(sum(tokens.values()) - want_grads["gate"]).max())
    for name in ("w_in", "w_out"):
        summed = np.zeros_like(want_grads[name])
        for r in ranks:
            e0, en = r["experts"]
            summed[e0:e0 + en] += r[name]
        err[name] = float(np.abs(summed - want_grads[name]).max())
    return err


@pytest.mark.parametrize("case", sorted(set(TWO) - {"planted", "fsdp2_whole_own"}) + sorted(FOUR))
def test_sparse_layer_over_split_tokens_matches_jax_global_groups(case, worlds):
    table = {**TWO, **FOUR}
    err = _errors(worlds[case], *_jax(table[case]))
    assert err["out"] <= ATOL_OUT, err
    assert max(err[k] for k in ("x", "gate", "w_in", "w_out")) <= ATOL_GRAD, err


def test_tight_capacity_drops_routings(worlds):
    """At capacity 0.5 about half the routings have no slot: the outputs
    of the tight and the ample runs differ, so the parity above is a test
    of which routings the groups drop."""
    tight, ample = worlds["fsdp2_cf0.5"][0]["out"], worlds["fsdp2_cf4"][0]["out"]
    assert np.abs(tight - ample).max() > 0.1


def test_whole_groups_on_a_rank_are_its_own_grouping_bit_for_bit(worlds):
    for got, own in zip(worlds["fsdp2_whole"], worlds["fsdp2_whole_own"]):
        for key in ("out", "x", "gate", "w_in", "w_out"):
            np.testing.assert_array_equal(got[key], own[key], err_msg=key)


def test_planted_rank_grouping_reads_above_the_limit(worlds):
    err = _errors(worlds["planted"], *_jax(TWO["planted"]))
    assert err["out"] > PLANT_MIN, err


def test_data_index_is_train_coords(worlds):
    """The four-rank world's token rows are its data coordinates' (dp
    outermost, as ``train_coords`` orders the data axes)."""
    ranks = worlds["dp2_ep2_cf0.5"]
    assert [r["data_index"] for r in ranks] == [0, 0, 1, 1]
    assert [r["rows"] for r in ranks] == [(0, 2), (0, 2), (2, 2), (2, 2)]
    assert [r["experts"] for r in ranks] == [(0, 2), (2, 2), (0, 2), (2, 2)]


@pytest.mark.parametrize(
    "rows_total,seq,extent,sp,accum",
    [(4, 32, 2, 1, 1), (4, 32, 1, 2, 1), (8, 16, 2, 2, 2), (8, 12, 4, 3, 2), (12, 8, 3, 2, 2),
     (16, 4, 2, 1, 4)],
)
def test_global_token_index_is_the_reference_order(rows_total, seq, extent, sp, accum):
    """Every rank of every microbatch: the helper's indices are the
    reference's places of the rank's tokens in its microbatch (JAX's
    ``tokens.reshape(A, B/A, S)``, row-major), and the ranks' indices of a
    microbatch are each of its tokens once."""
    ids = np.arange(rows_total * seq).reshape(rows_total, seq)
    mb_rows, n = rows_total // accum, seq // sp
    rows = mb_rows // extent
    for m in range(accum):
        seen = []
        for d, j in itertools.product(range(extent), range(sp)):
            fed = data_lib.global_batch(ids, d, extent, accum)
            mine = fed.reshape(accum, rows, seq)[m][:, j * n:(j + 1) * n].reshape(-1)
            got = moe.global_token_index(rows, seq, d, (j * n, n) if sp > 1 else None)
            np.testing.assert_array_equal(got, mine - m * mb_rows * seq)
            seen.append(got)
        np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(mb_rows * seq))


def _counted(axes: dict, group_size: int = 1024):
    params, x = _inputs()

    def f(gate, w_in, w_out, x):
        tokens = moe.TokenSplit(tuple(axes), B // axes.get("fsdp", 1), S)
        y = moe.moe_mlp_sparse({"gate": gate, "w_in": w_in, "w_out": w_out}, x, top_k=2,
                               capacity_factor=0.5, group_size=group_size, tokens=tokens)
        y.float().sum().backward()

    def leaf(a):
        return torch.tensor(a, requires_grad=True)

    n = B * S // int(np.prod(list(axes.values())))
    return count_collectives(f, *(leaf(params[k]) for k in ("gate", "w_in", "w_out")),
                             leaf(x.reshape(-1, D)[:n]), axes=axes)


def test_count_collectives_records_the_index_gather():
    two = _counted({"fsdp": 2})
    assert two.calls == {"all_gather": 1.0}
    assert two.bytes == {"all_gather": B * S // 2 * 2}  # int8 indices, top 2
    both = _counted({"fsdp": 2, "sp": 2})
    assert both.calls == {"all_gather": 2.0}
    assert _counted({"fsdp": 2}, group_size=64).calls == {}
