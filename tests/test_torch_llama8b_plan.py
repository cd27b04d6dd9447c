"""The Llama-3-8B sharding plan of the port, without a world: the port's
counterpart of ``tests/test_llama8b_plan.py``.

The 8B is built on the ``meta`` device (no memory) and laid out abstractly
as a world at dp=2, fsdp=8, tp=2 would lay it out: tp splits each tensor's
``parallel/sharding.tp_dim`` (the rule table), FSDP2 then shards dim 0 of
the tp block over fsdp in ``torch.chunk``'s blocks, dp replicates. Checked:
every tensor above 2^16 elements is sharded; no mesh axis is used twice in
one tensor; the parameter count is the JAX model's; each JAX leaf's
per-device bytes equal the sum of its port tensors' (the dims differ: the
port splits ``[out, in]`` weights and FSDP2 takes dim 0; the bytes do not),
but for the norm scales, which JAX replicates and FSDP2 shards too.
"""

import math

import tests.jaxenv  # noqa: F401

from pytorch_operator_tpu_torch.models import convert
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.parallel import sharding
from tests.test_llama8b_plan import MESH_EXTENTS, _per_device_bytes


def _port_plan(name: str, shape) -> tuple:
    """``(per-device elements, mesh axes of each dim)`` of one port tensor
    at dp=2, fsdp=8, tp=2."""
    axes = [[] for _ in shape]
    block = list(shape)
    dim = sharding.tp_dim(name)
    if dim is not None:
        assert block[dim] % MESH_EXTENTS["tp"] == 0, name
        block[dim] //= MESH_EXTENTS["tp"]
        axes[dim].append("tp")
    rows = block[0]
    block[0] = -(-rows // MESH_EXTENTS["fsdp"])  # FSDP2's largest chunk
    axes[0].append("fsdp")
    return math.prod(block), axes


def test_port_plan_matches_the_jax_plan():
    import flax.linen as nn
    import jax
    import numpy as np

    from pytorch_operator_tpu.models import llama as jax_llama
    from pytorch_operator_tpu.parallel.sharding import logical_to_spec

    cfg = port_llama.llama3_8b()
    model = port_llama.Llama(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    n_params = sum(math.prod(s) for s in shapes.values())

    jmodel = jax_llama.Llama(jax_llama.llama3_8b())
    abstract = jax.eval_shape(lambda k: jmodel.init(k, np.zeros((1, 32), np.int32)), jax.random.key(0))
    specs = nn.get_partition_spec(abstract)["params"]
    params = abstract["params"]
    assert n_params == sum(math.prod(x.shape) for x in jax.tree.leaves(params))
    assert abs(n_params / 1e6 - 8030.3) < 0.1

    port_bytes = {}
    for name, shape in shapes.items():
        elems, axes = _port_plan(name, shape)
        used = [a for dim in axes for a in dim]
        assert len(used) == len(set(used)), (name, axes)
        if math.prod(shape) > 2**16:
            assert elems < math.prod(shape), f"{name} {shape} is not sharded"
        port_bytes[name] = elems * 4  # f32 parameters, as JAX's default

    def node(tree, path):
        for part in path.split("/"):
            tree = tree[part]
        return tree

    total_jax = total_port = 0
    for leaf in convert.jax_leaves(cfg):
        x = node(params, leaf.path)
        x = x.unbox() if hasattr(x, "unbox") else x
        spec = logical_to_spec(tuple(node(specs, leaf.path)))
        jax_b, _ = _per_device_bytes(x.shape, 4, spec)
        mine = sum(port_bytes[n] for n in leaf.names)
        total_jax, total_port = total_jax + jax_b, total_port + mine
        if leaf.norm:
            # JAX replicates the norm scales; FSDP2 shards them over fsdp.
            assert mine == jax_b / MESH_EXTENTS["fsdp"], leaf.path
        else:
            assert mine == jax_b, (leaf.path, mine, jax_b)
    assert total_port < total_jax < 1.001 * total_port
    # About 8.03 GB of f32 parameters over 16 shards a device.
    assert abs(total_port - 4 * n_params / 16) / total_port < 1e-3
