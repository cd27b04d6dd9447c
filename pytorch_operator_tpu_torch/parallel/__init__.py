"""Parallelism — the port of ``pytorch_operator_tpu/parallel/``.

Only the single-device mixture-of-experts layer is ported (``moe.py``); the
meshes, sharding rules, ring and ulysses attention and the pipeline are
ROADMAP.md item 3b (multi-GPU).
"""

from .moe import (  # noqa: F401
    load_balance_loss,
    moe_mlp,
    moe_mlp_reference,
    moe_mlp_sparse,
)
