"""Parallelism — the port of ``pytorch_operator_tpu/parallel/``.

- ``mesh.py``: the mesh-spec grammar and ``DeviceMesh`` construction over
  the ranks of a joined world (``dp``, ``fsdp``, ``tp``, the ``@dcn``
  layout), and a rank's data and tp coordinates (``train_coords``).
- ``collectives.py``: psum, pmax, pmean, all-gather, reduce-scatter, the
  ring shift, over the process group of one mesh axis; tp's enter and leave
  as autograd functions.
- ``data.py``: each rank's rows of the identical host batch.
- ``sharding.py`` / ``logical.py``: the rule table, tp's blocks of the
  Llama's tensors, and FSDP2 over the data axes (``fsdp`` shards, ``dp``
  replicates).
- ``moe.py``: the mixture-of-experts layer on one device.

Sequence (ring, ulysses) and expert parallelism are ROADMAP.md item 3c-2,
pipeline parallelism 3c-3.
"""

from .collectives import all_gather, axis_index, axis_size, pmax, pmean, psum, reduce_scatter, ring_shift  # noqa: F401
from .mesh import (  # noqa: F401
    MESH_AXIS_ORDER,
    make_hybrid_mesh,
    make_mesh,
    mesh_from_env,
    parse_mesh_spec,
    resolve_axis_sizes,
    split_hybrid_spec,
)
from .moe import (  # noqa: F401
    load_balance_loss,
    moe_mlp,
    moe_mlp_reference,
    moe_mlp_sparse,
)
