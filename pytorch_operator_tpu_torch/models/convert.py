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
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.quantize import scale_name
from .llama import LlamaConfig


def params_from_jax(tree, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict for the JAX param ``tree`` of config ``cfg``.
    Raises ``ValueError`` naming the first leaf whose shape disagrees, or
    whose quantization disagrees with ``cfg.quantize``."""
    H, K, D, M, Fd, V, L = (
        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.d_ff,
        cfg.vocab_size, cfg.n_layers,
    )
    sd: Dict[str, torch.Tensor] = {}

    def node(path: str):
        n = tree
        for part in path.split("/"):
            n = n[part]
        return n

    def norm(path: str, shape) -> torch.Tensor:
        a = np.array(node(path), dtype=np.float32)  # a writable copy
        _check(path, a.shape, shape)
        return torch.from_numpy(a)

    def weight(path: str, shape) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The leaf at ``path`` as ``(weight or q, scale or None)``."""
        leaf = node(path)
        quantized = _is_quantized(leaf)
        if quantized != (cfg.quantize == "int8"):
            raise ValueError(
                f"JAX param {path} is {'' if quantized else 'not '}quantized, "
                f"config has quantize={cfg.quantize!r}"
            )
        if not quantized:
            a = np.array(leaf, dtype=np.float32)
            _check(path, a.shape, shape)
            return torch.from_numpy(a), None
        q = np.array(leaf.q, dtype=np.int8)
        _check(path, q.shape, shape)
        return torch.from_numpy(q), torch.from_numpy(np.array(leaf.scale, dtype=np.float32))

    def put(name: str, leaf, to_port: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """``to_port`` maps the JAX layout onto ``[out, in]``: applied to
        ``q`` and to its scale alike."""
        w, scale = leaf
        if scale is None:
            sd[name] = to_port(w).to(cfg.param_dtype).contiguous()
        else:
            sd[name] = to_port(w).contiguous()
            sd[scale_name(name)] = to_port(scale).contiguous()

    put("embed.weight", weight("embed/embedding", (V, M)), lambda a: a)
    sd["final_norm.weight"] = norm("final_norm/scale", (M,))
    put("lm_head.weight", weight("lm_head/kernel", (M, V)), lambda a: a.t())
    attn_norm = norm("layers/attn_norm/scale", (L, M))
    mlp_norm = norm("layers/mlp_norm/scale", (L, M))
    stacked = {
        "attn.q_proj": weight("layers/attn/q_proj/kernel", (L, M, H, D)),
        "attn.k_proj": weight("layers/attn/k_proj/kernel", (L, M, K, D)),
        "attn.v_proj": weight("layers/attn/v_proj/kernel", (L, M, K, D)),
        "attn.o_proj": weight("layers/attn/o_proj/kernel", (L, H * D, M)),
        "mlp.gate_proj": weight("layers/mlp/gate_proj/kernel", (L, M, Fd)),
        "mlp.up_proj": weight("layers/mlp/up_proj/kernel", (L, M, Fd)),
        "mlp.down_proj": weight("layers/mlp/down_proj/kernel", (L, Fd, M)),
    }
    for i in range(L):
        p = f"layers.{i}."
        sd[p + "attn_norm.weight"] = attn_norm[i].clone()
        sd[p + "mlp_norm.weight"] = mlp_norm[i].clone()
        for name, leaf in stacked.items():
            if name in ("attn.q_proj", "attn.k_proj", "attn.v_proj"):
                # [M, heads, D] (scale [1, heads, D]) -> [heads * D, M].
                to_port = lambda a, i=i: a[i].reshape(a.shape[1], -1).t()  # noqa: E731
            else:
                to_port = lambda a, i=i: a[i].t()  # noqa: E731
            put(p + name + ".weight", leaf, to_port)
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
