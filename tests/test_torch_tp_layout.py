"""Tensor parallelism's layout of the Llama, in one process: the rule
table's tp dims against the JAX model's annotations, a tp rank's blocks
(from ``params_from_jax`` and from the seeded init) against the whole
tensors, the vocab-parallel embedding and loss of two blocks against one
whole model, and what is refused by name (``sp``, ``ep``, ``pp``; a tp
that does not divide the heads; decoding and serving a tp model)."""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401
import torch

from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu_torch.models import convert
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.parallel import mesh as mesh_lib
from pytorch_operator_tpu_torch.parallel import sharding
from pytorch_operator_tpu_torch.parallel.sharding import TensorParallel
from pytorch_operator_tpu_torch.workloads import llama_train


@pytest.fixture(scope="module")
def jax_tree_and_specs():
    import flax.linen as nn
    import jax

    model = jax_llama.Llama(jax_llama.llama_tiny())
    variables = model.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    specs = nn.get_partition_spec(variables)["params"]
    return jax.device_get(nn.meta.unbox(variables["params"])), specs


def _node(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def test_tp_dims_follow_the_jax_annotations(jax_tree_and_specs):
    """For every JAX leaf, the dim the rule table gives ``tp`` in the JAX
    layout maps to the port's ``tp_dim`` of its tensor (``[in, out]`` →
    ``[out, in]``; q/k/v's heads → the rows)."""
    from pytorch_operator_tpu.parallel.sharding import logical_to_spec

    _, specs = jax_tree_and_specs
    for leaf in convert.jax_leaves(port_llama.llama_tiny()):
        logical = tuple(_node(specs, leaf.path))
        mesh_axes = tuple(logical_to_spec(logical))
        mesh_axes += (None,) * (len(logical) - len(mesh_axes))
        jdims = [i for i, ax in enumerate(mesh_axes) if ax == "tp" or (isinstance(ax, tuple) and "tp" in ax)]
        jdim = (jdims[0] - leaf.stacked) if jdims else None
        port = sharding.tp_dim(leaf.names[0])
        if jdim is None:
            assert port is None, leaf.path
        elif leaf.layout == "t":
            assert port == 1 - jdim, leaf.path
        elif leaf.layout == "heads":
            assert jdim == 1 and port == 0, leaf.path  # [M, heads, D]: the heads are the rows
        else:
            assert port == jdim, leaf.path


def test_params_from_jax_and_the_init_give_each_rank_its_block(jax_tree_and_specs):
    tree, _ = jax_tree_and_specs
    cfg = port_llama.llama_tiny()
    whole = convert.params_from_jax(tree, cfg)
    parts = [convert.params_from_jax(tree, cfg, TensorParallel(2, i)) for i in range(2)]
    model = port_llama.Llama(cfg)
    model.init_weights(torch.Generator().manual_seed(3))
    inits = []
    for i in range(2):
        m = port_llama.Llama(cfg, tp=TensorParallel(2, i))
        m.init_weights(torch.Generator().manual_seed(3))
        assert m.state_dict().keys() == whole.keys()
        inits.append(m.state_dict())
    for name, t in whole.items():
        dim = sharding.tp_dim(name)
        for blocks, full in ((parts, t), (inits, model.state_dict()[name])):
            if dim is None:
                assert all(torch.equal(b[name], full) for b in blocks), name
            else:
                assert torch.equal(torch.cat([b[name] for b in blocks], dim), full), name
                assert blocks[1][name].shape[dim] == full.shape[dim] // 2


def test_blocks_say_where_a_rank_part_sits():
    t = torch.zeros(6, 4)
    b = sharding.Block.of(t, 1, TensorParallel(2, 1))
    assert (b.offsets, b.shape, b.writer) == ((0, 4), (6, 8), True)
    b = sharding.Block.of(t, None, TensorParallel(2, 1))
    assert (b.offsets, b.shape, b.writer) == ((0, 0), (6, 4), False)
    assert mesh_lib.train_coords(None) == mesh_lib.TrainCoords(0, 1, 0, 1)


@pytest.mark.parametrize(
    "spec,item", [("sp=2", "3c-2"), ("ep=2", "3c-2"), ("pp=2", "3c-3"), ("dp=1,pp=2", "3c-3")]
)
def test_sp_ep_and_pp_are_refused_naming_their_item(spec, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md item {item}"):
        llama_train.resolve_train_mesh(spec, 2)
    assert llama_train.resolve_train_mesh("fsdp=2,tp=2", 4) == {"fsdp": 2, "tp": 2}


def test_the_pipeline_flags_are_refused_naming_3c3():
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 3c-3"):
        llama_train.main(["--device", "cpu", "--pp-microbatches", "4"])


def test_a_tp_that_does_not_divide_is_refused_by_name():
    cfg = port_llama.llama_tiny()  # 4 heads, 2 kv heads
    with pytest.raises(NotImplementedError, match="tp=4 does not divide n_kv_heads=2"):
        port_llama.Llama(cfg, tp=TensorParallel(4, 0))
    with pytest.raises(NotImplementedError, match="d_ff=128"):
        sharding.check_tp_divides(port_llama.llama_tiny(n_kv_heads=3, n_heads=3, vocab_size=255), 3)


def test_decoding_and_serving_a_tp_model_are_refused():
    import dataclasses

    from pytorch_operator_tpu_torch.serving.engine import ServingEngine

    tp = TensorParallel(2, 0)
    cfg = port_llama.llama_tiny()
    with pytest.raises(NotImplementedError, match="decoding"):
        port_llama.Llama(dataclasses.replace(cfg, decode=True), tp=tp)
    model = port_llama.Llama(cfg, tp=tp)
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        ServingEngine(dataclasses.replace(cfg, decode=True, max_decode_len=64), model)
    with pytest.raises(ValueError, match="hidden states"):
        model(torch.zeros((1, 4), dtype=torch.long))


def test_example_llama_tp_runs_under_the_supervisor(tmp_path):
    """``examples/llama-tp-torch.yaml`` as written: Master + 1 Worker at
    tp=2 train to success; the Master's result shows the tp layout."""
    import json
    from pathlib import Path

    from pytorch_operator_tpu.api import load_job
    from pytorch_operator_tpu.controller import Supervisor

    job = load_job(Path(__file__).resolve().parents[1] / "examples" / "llama-tp-torch.yaml")
    job.spec.port = None
    sup = Supervisor(state_dir=tmp_path / "state", poll_interval=0.1)
    try:
        done = sup.run(job, timeout=240)
    finally:
        sup.shutdown()
    log = (tmp_path / "state" / "logs" / "default_llama-tp-torch-master-0.log").read_text()
    assert done.is_succeeded(), log[-3000:]
    result = json.loads(log.strip().splitlines()[-1])
    assert result["mesh"] == {"tp": 2} and result["world"] == 2 and result["backend"] == "gloo"
    assert [(r["data_index"], r["tp_index"]) for r in result["per_rank"]] == [(0, 0), (0, 1)]
    assert result["per_rank"][0]["param_bytes"] < 4 * sum(
        p.numel() for p in port_llama.Llama(port_llama.llama_tiny()).parameters())
