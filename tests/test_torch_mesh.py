"""The port's mesh, data, sharding-rule and collective layers
(pytorch_operator_tpu_torch/parallel/{mesh,data,sharding,logical,
collectives}.py) against the JAX package's, on the CPU.

- One table of mesh specs through both packages' ``parse_mesh_spec``,
  ``resolve_axis_sizes`` and ``split_hybrid_spec``, errors included; the
  port's layout of each spec (hybrid ``@dcn`` axes outermost) equals the
  axis names and shape of the JAX mesh over the same device count.
- ``global_batch`` takes JAX's process slice of the host batch, rank by rank.
- The rule table maps logical axes as JAX's does.
- Each collective in a two-rank gloo world agrees with numpy.
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import jax

from pytorch_operator_tpu.parallel import data as jax_data
from pytorch_operator_tpu.parallel import logical as jax_logical
from pytorch_operator_tpu.parallel import mesh as jax_mesh
from pytorch_operator_tpu.parallel import sharding as jax_sharding
from pytorch_operator_tpu_torch.parallel import data, logical, mesh, sharding
from tests import torch_worlds

SPECS = [
    ("fsdp=-1", 8), ("fsdp=2", 2), ("dp=2", 2), ("dp=2,fsdp=4", 8), ("tp=2,fsdp=-1", 8),
    ("fsdp=4,dp=2", 8), ({"dp": 2, "tp": -1}, 8), ("", 4), (" dp = 2 , fsdp=-1 ", 4),
    ("dp=2@dcn,fsdp=-1", 8), ("dp=2@dcn,fsdp=-1", 2), ("dp=2@dcn", 2), ("pp=2,dp=2@dcn,fsdp=-1", 8),
    ("dp=3", 8), ("fsdp=-1,tp=-1", 8), ("xp=2", 2), ("dp=0", 2), ("dp", 2), ("dp=2,fsdp=3", 6),
    ("fsdp=3", 8), ("dp=-1@dcn,fsdp=2", 8), ("dp=2@dcn,fsdp=-1", 6), ("dp=4@dcn", 8),
    ("dp=2@dcn,dp=2", 4), ("dp=x", 2),
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the error is what is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec,n", SPECS, ids=[f"{s!r}-{n}" for s, n in SPECS])
def test_mesh_spec_parsing_matches_jax(spec, n):
    assert _outcome(mesh.parse_mesh_spec, spec) == _outcome(jax_mesh.parse_mesh_spec, spec)
    assert _outcome(mesh.resolve_axis_sizes, spec, n) == _outcome(jax_mesh.resolve_axis_sizes, spec, n)
    if isinstance(spec, str):
        assert mesh.split_hybrid_spec(spec) == jax_mesh.split_hybrid_spec(spec)

    def jax_layout():
        m = jax_mesh.make_mesh(spec, devices=jax.devices()[:n])
        return dict(zip(m.axis_names, m.devices.shape))

    if n <= len(jax.devices()):
        want = _outcome(jax_layout)
        got = _outcome(mesh.hybrid_axis_sizes, spec, n)
        assert got[0] == want[0], (got, want)
        if got[0] == "ok":
            assert list(got[1].items()) == list(want[1].items())


def test_make_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="needs a joined world"):
        mesh.make_mesh("fsdp=-1", "cpu")


@pytest.mark.parametrize("n,rows", [(1, 8), (2, 8), (4, 8), (2, 6), (3, 7)])
def test_global_batch_rows_are_jax_process_slice(n, rows, monkeypatch):
    """JAX's ``global_batch`` with ``process_count``/``process_index``
    stubbed and the local rows it hands to ``make_array_from_process_local_data``
    captured, against the port's for each rank."""
    batch = np.arange(rows * 3).reshape(rows, 3)
    jm = jax_mesh.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    for pid in range(n):
        monkeypatch.setattr(jax, "process_count", lambda: n)
        monkeypatch.setattr(jax, "process_index", lambda: pid)
        monkeypatch.setattr(jax, "make_array_from_process_local_data",
                            lambda sharding, local, shape: np.asarray(local))
        want = _outcome(lambda: np.asarray(jax_data.global_batch(batch, jm)) if n > 1 else batch)
        got = _outcome(data.global_batch, batch, pid, n)
        assert got[0] == want[0]
        if got[0] == "ok":
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got == want


def test_shard_batch_size_and_epoch_batches_match_jax():
    for axes, size in (({"dp": 2, "fsdp": 4}, 8), ({"fsdp": 8}, 8), ({"dp": 4, "tp": 2}, 6)):
        jm = jax_mesh.make_mesh(axes, devices=jax.devices()[:8])
        for axis in ("dp", "fsdp"):
            assert _outcome(data.shard_batch_size, size, axes, axis) == _outcome(
                jax_data.shard_batch_size, size, jm, axis)
    x, y = np.arange(20).reshape(10, 2), np.arange(10)
    for drop in (True, False):
        got = list(data.epoch_batches(x, y, 3, seed=5, drop_last=drop))
        want = list(jax_data.epoch_batches(x, y, 3, seed=5, drop_last=drop))
        assert len(got) == len(want)
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("axes", [("dp", "fsdp"), ("fsdp",), ("dp",), ("dp", "fsdp", "tp"), ("pp", "sp")])
def test_rule_table_matches_jax(axes):
    jm = jax_mesh.make_mesh({a: 1 for a in axes}, devices=jax.devices()[:1])
    assert logical.rules_for_mesh(axes) == jax_logical.rules_for_mesh(jm)
    for logical_axes in (("batch", "seq"), ("embed", "mlp"), ("vocab", "embed"), ("layers", "heads", None)):
        want = tuple(jax_sharding.logical_to_spec(logical_axes, mesh=jm))
        assert tuple(sharding.logical_to_mesh_axes(logical_axes, mesh_axes=axes)) == want
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES
    assert sharding.data_axes(axes) == tuple(a for a in axes if a in ("dp", "fsdp"))


SHAPES = [(4, 6), (2, 4, 3)]


@pytest.fixture(scope="module")
def world_collectives():
    return torch_worlds.run_world("collectives", SHAPES)


@pytest.mark.parametrize("axis", ["dp", "fsdp"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_collectives_agree_with_numpy(world_collectives, axis, shape):
    n = 2
    xs = [np.arange(float(np.prod(shape))).reshape(shape) + 100 * r for r in range(n)]
    total = sum(xs)
    for r in range(n):
        got = world_collectives[r][(axis, shape)]
        assert got["index"] == (r, n)
        np.testing.assert_array_equal(got["psum"], total)
        np.testing.assert_array_equal(got["pmean"], total / n)
        np.testing.assert_array_equal(got["all_gather"], np.concatenate(xs))
        np.testing.assert_array_equal(got["all_gather_stacked"], np.stack(xs))
        np.testing.assert_array_equal(got["reduce_scatter"], np.split(total, n, 0)[r])
        np.testing.assert_array_equal(got["reduce_scatter_dim1"], np.split(total, n, 1)[r])
        np.testing.assert_array_equal(got["ring_shift"], xs[(r - 1) % n])
        np.testing.assert_array_equal(got["ring_shift_back"], xs[(r + 1) % n])


@pytest.mark.parametrize("axis", ["dp", "fsdp"])
@pytest.mark.parametrize("rows", [4, 5, 1])
def test_full_tensor_gathers_fsdp_shards(world_collectives, axis, rows):
    """``sharding.full_tensor`` (c10d all-gather of padded rows) rebuilds a
    DTensor sharded on dim 0, the last rank's rows short or empty."""
    for r in range(2):
        np.testing.assert_array_equal(world_collectives[r][(axis, "full", rows)],
                                      np.arange(rows * 3.0).reshape(rows, 3))


def test_mesh_layouts_in_a_world(world_collectives):
    """Two ranks: the hybrid mesh puts its dcn axis outermost (by argument
    and by ``@dcn`` spec), and ``mesh_from_env`` defaults to ``fsdp=-1``."""
    for r in range(2):
        layouts = world_collectives[r]["layouts"]
        assert layouts["hybrid"] == layouts["hybrid_spec"] == (("dp", "fsdp"), (2, 1))
        assert layouts["env_default"] == (("fsdp",), (2,))
