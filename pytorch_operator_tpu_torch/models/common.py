"""Helpers shared across model families — the port of
``pytorch_operator_tpu/models/common.py``."""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable`` in PyTorch's terms: keep the
    outputs of the 2-D GEMMs (``aten.mm``, ``aten.addmm``: the projections
    and the MLP, whose 3-D inputs ``F.linear`` folds to 2-D; in a MoE block
    the router's product and dense dispatch's first expert product, which
    ``parallel/moe.py`` writes as ``mm``), recompute everything else (norms,
    rotary, activations, batched attention products, the MoE layer's
    batched ``bmm`` products, as JAX's policy recomputes its batched
    einsums)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(cfg):
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for
    ``cfg.remat_policy``: None for ``"full"`` (save only the block's inputs,
    recompute the whole block in the backward), selective checkpointing that
    saves the GEMM outputs for ``"dots"``. Duck-typed: any config with a
    ``remat_policy`` field.

    The flash kernels launch through ``ctypes``, outside PyTorch's
    dispatcher, so no policy sees them: the backward recomputes the
    attention forward (one more ``flash_fwd`` launch a layer), as the JAX
    ``dots`` policy does not save the Pallas kernel's output either."""
    if cfg.remat_policy == "full":
        return None
    if cfg.remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _save_dots)
    raise ValueError(f"remat_policy={cfg.remat_policy!r} not in ('full', 'dots')")
