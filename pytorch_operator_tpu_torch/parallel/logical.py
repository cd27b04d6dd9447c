"""Logical-axis plumbing — the port of
``pytorch_operator_tpu/parallel/logical.py``.

JAX's module turns flax's logical-axis annotations into NamedShardings for
a sharded init. The port's model carries no annotations: FSDP2 lays out
whole modules (``sharding.shard_model``), and every rank builds the same
init before it shards. What carries over is the rule filter that makes one
rule table serve every mesh shape.
"""

from __future__ import annotations

from .sharding import DEFAULT_RULES, LogicalRules, filter_axis_for_mesh


def rules_for_mesh(mesh_axes, rules: LogicalRules = DEFAULT_RULES) -> LogicalRules:
    """The rule table filtered to the axes a mesh has (``mesh_axes``: a
    ``DeviceMesh``'s ``mesh_dim_names`` or any iterable of names)."""
    names = set(getattr(mesh_axes, "mesh_dim_names", None) or mesh_axes)
    return tuple((logical, filter_axis_for_mesh(ax, names)) for logical, ax in rules)
