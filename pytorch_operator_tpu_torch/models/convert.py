"""Load a JAX Llama param tree into the port's ``Llama``.

The JAX package's ``Llama.init`` yields nested dicts whose layer leaves are
stacked ``[n_layers, ...]`` (flax ``nn.scan``) and whose matmul kernels keep
``DenseGeneral``'s ``[in, ...out]`` shape. :func:`params_from_jax` takes that
tree as nested dicts of numpy arrays (e.g. after ``jax.device_get``) and
returns the port's ``state_dict``: per-layer ``[out, in]`` weights, the norm
scales in float32, and every other weight in ``cfg.param_dtype``, the dtype
the port's ``Llama`` holds its parameters in. A serving model casts its matmul
weights to ``cfg.dtype`` once after loading
(:meth:`~pytorch_operator_tpu_torch.models.llama.Llama.cast_matmul_weights_`).

A tree that came out of the JAX package's ``quantize_tree`` holds its matmul
weights as ``QuantizedTensor`` leaves (int8 ``q``, f32 ``scale``). The port
cannot import that class and recognises such a leaf by its ``q`` and
``scale`` attributes; it then returns the int8 state dict of a
``quantize="int8"`` model, bit for bit: ``q`` and ``scale`` go through the
same transposes and reshapes, ``<module>.weight`` holding ``q`` and
``<module>.scale`` the scale (e.g. q/k/v ``q`` ``[L, M, H, D]`` with scale
``[L, 1, H, D]`` become ``[H·D, M]`` and ``[H·D, 1]``).

The mapping between the two layouts lives in one place, :func:`jax_leaves`:
one :class:`JaxLeaf` a JAX param leaf, with the port tensors it holds and the
two directions between them. :func:`params_from_jax` reads it one way; the
port's adafactor (``workloads/trainer.py``) reads it both ways, since optax
picks the factored axes and takes the block RMS on the JAX leaf, not on the
port's per-layer tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.quantize import scale_name
from .llama import LlamaConfig


@dataclass(frozen=True)
class JaxLeaf:
    """One JAX param leaf and the port tensors it holds.

    ``shape`` is the JAX leaf's; ``names`` the port's state-dict names, one a
    layer for a leaf stacked over layers (``nn.scan``), else one. ``layout``
    maps a JAX slice onto a port tensor: ``"same"``; ``"t"``, the transpose
    (``DenseGeneral``'s ``[in, out]`` to ``nn.Linear``'s ``[out, in]``); or
    ``"heads"``, ``[M, heads, D]`` to ``[heads·D, M]`` (q, k and v)."""

    path: str
    shape: Tuple[int, ...]
    names: Tuple[str, ...]
    layout: str
    stacked: bool
    norm: bool = False

    def to_port(self, a: torch.Tensor, i: int = 0) -> torch.Tensor:
        """The port tensor ``names[i]`` of the JAX-layout ``a`` (a view where
        possible). Also maps a quantized leaf's scale, whose reduced axis has
        extent 1."""
        x = a[i] if self.stacked else a
        if self.layout == "t":
            return x.t()
        if self.layout == "heads":
            return x.reshape(x.shape[0], -1).t()
        return x

    def from_port(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The JAX-layout leaf of the port tensors ``tensors`` (one a name),
        stacked over layers where the leaf is."""

        def one(t):
            if self.layout == "t":
                return t.t()
            if self.layout == "heads":
                return t.t().reshape(t.shape[1], *self.shape[-2:])
            return t

        if self.stacked:
            return torch.stack([one(t) for t in tensors])
        (t,) = tensors
        return one(t).contiguous()


def jax_leaves(cfg: LlamaConfig) -> List[JaxLeaf]:
    """The JAX param leaves of a dense Llama of config ``cfg``, each with
    the port tensors it holds (the order in which :func:`params_from_jax`
    checks them)."""
    H, K, D, M, Fd, V, L = (
        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.d_ff,
        cfg.vocab_size, cfg.n_layers,
    )

    def layers(name):
        return tuple(f"layers.{i}.{name}" for i in range(L))

    return [
        JaxLeaf("embed/embedding", (V, M), ("embed.weight",), "same", False),
        JaxLeaf("final_norm/scale", (M,), ("final_norm.weight",), "same", False, norm=True),
        JaxLeaf("lm_head/kernel", (M, V), ("lm_head.weight",), "t", False),
        JaxLeaf("layers/attn_norm/scale", (L, M), layers("attn_norm.weight"), "same", True, norm=True),
        JaxLeaf("layers/mlp_norm/scale", (L, M), layers("mlp_norm.weight"), "same", True, norm=True),
        JaxLeaf("layers/attn/q_proj/kernel", (L, M, H, D), layers("attn.q_proj.weight"), "heads", True),
        JaxLeaf("layers/attn/k_proj/kernel", (L, M, K, D), layers("attn.k_proj.weight"), "heads", True),
        JaxLeaf("layers/attn/v_proj/kernel", (L, M, K, D), layers("attn.v_proj.weight"), "heads", True),
        JaxLeaf("layers/attn/o_proj/kernel", (L, H * D, M), layers("attn.o_proj.weight"), "t", True),
        JaxLeaf("layers/mlp/gate_proj/kernel", (L, M, Fd), layers("mlp.gate_proj.weight"), "t", True),
        JaxLeaf("layers/mlp/up_proj/kernel", (L, M, Fd), layers("mlp.up_proj.weight"), "t", True),
        JaxLeaf("layers/mlp/down_proj/kernel", (L, Fd, M), layers("mlp.down_proj.weight"), "t", True),
    ]


def params_from_jax(tree, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict for the JAX param ``tree`` of config ``cfg``.
    Raises ``ValueError`` naming the first leaf whose shape disagrees, or
    whose quantization disagrees with ``cfg.quantize``."""
    sd: Dict[str, torch.Tensor] = {}

    def node(path: str):
        n = tree
        for part in path.split("/"):
            n = n[part]
        return n

    for leaf in jax_leaves(cfg):
        raw = node(leaf.path)
        if leaf.norm:
            w, scale = torch.from_numpy(np.array(raw, dtype=np.float32)), None
        else:
            quantized = _is_quantized(raw)
            if quantized != (cfg.quantize == "int8"):
                raise ValueError(
                    f"JAX param {leaf.path} is {'' if quantized else 'not '}quantized, "
                    f"config has quantize={cfg.quantize!r}"
                )
            if quantized:
                w = torch.from_numpy(np.array(raw.q, dtype=np.int8))
                scale = torch.from_numpy(np.array(raw.scale, dtype=np.float32))
            else:
                w, scale = torch.from_numpy(np.array(raw, dtype=np.float32)), None
        _check(leaf.path, w.shape, leaf.shape)
        for i, name in enumerate(leaf.names):
            if leaf.norm:
                sd[name] = leaf.to_port(w, i).clone()
            elif scale is None:
                sd[name] = leaf.to_port(w, i).to(cfg.param_dtype).contiguous()
            else:
                sd[name] = leaf.to_port(w, i).contiguous()
                sd[scale_name(name)] = leaf.to_port(scale, i).contiguous()
    return sd


def is_quantized_tree(tree) -> bool:
    """Whether a JAX param tree came out of ``quantize_tree`` (its head
    kernel is a ``QuantizedTensor``)."""
    return _is_quantized(tree["lm_head"]["kernel"])


def _is_quantized(leaf) -> bool:
    return hasattr(leaf, "q") and hasattr(leaf, "scale")


def _check(path: str, got, want) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"JAX param {path} has shape {tuple(got)}, config expects {tuple(want)}")
