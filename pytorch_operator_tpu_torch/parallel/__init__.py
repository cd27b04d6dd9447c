"""Parallelism — the port of ``pytorch_operator_tpu/parallel/``.

- ``mesh.py``: the mesh-spec grammar and ``DeviceMesh`` construction over
  the ranks of a joined world (``dp``, ``fsdp``, ``tp``, the ``@dcn``
  layout), and a rank's data, tp, sp, ep and pp coordinates
  (``train_coords``).
- ``collectives.py``: psum, pmax, pmean, all-gather, reduce-scatter, the
  ring shift and the all-to-all (the last two, and an all-gather along any
  dim, differentiable), the broadcast and a
  pipeline's neighbour exchange, over the process group of one mesh axis;
  tp's (and ep's) enter and leave as autograd functions.
- ``data.py``: each rank's rows of the identical host batch.
- ``sharding.py`` / ``logical.py``: the rule table, tp's and ep's blocks of
  the Llama's tensors (and tp's of BERT's), pp's stages, and FSDP2 over the data axes (``fsdp`` shards,
  ``dp`` replicates).
- ``ring.py`` / ``ulysses.py``: sequence parallelism over ``sp`` (K/V
  rotated around the ring; the all-to-all head/sequence swap, under tp
  over the global heads where a tp rank's own do not split over sp).
- ``moe.py``: the mixture-of-experts layer, on one device or with its
  experts over ``ep``.
- ``pipeline.py``: pipeline parallelism over ``pp`` (GPipe and 1F1B).
"""

from .collectives import (  # noqa: F401
    all_gather,
    all_gather_autograd,
    all_to_all,
    axis_index,
    axis_size,
    broadcast,
    neighbour_exchange,
    pmax,
    pmean,
    psum,
    reduce_scatter,
    ring_shift,
)
from .mesh import (  # noqa: F401
    MESH_AXIS_ORDER,
    make_hybrid_mesh,
    make_mesh,
    mesh_from_env,
    parse_mesh_spec,
    resolve_axis_sizes,
    split_hybrid_spec,
)
from .pipeline import pipeline_apply, pipeline_value_and_grad  # noqa: F401
from .ring import ring_attention_shard, ring_self_attention  # noqa: F401
from .ulysses import ulysses_attention_shard, ulysses_self_attention  # noqa: F401
from .moe import (  # noqa: F401
    load_balance_loss,
    moe_mlp,
    moe_mlp_reference,
    moe_mlp_sparse,
)
