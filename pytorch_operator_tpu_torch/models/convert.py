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
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .llama import LlamaConfig


def params_from_jax(tree, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict for the JAX param ``tree`` of config ``cfg``.
    Raises ``ValueError`` naming the first leaf whose shape disagrees."""
    H, K, D, M, Fd, V, L = (
        cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model, cfg.d_ff,
        cfg.vocab_size, cfg.n_layers,
    )

    def leaf(path: str, shape):
        node = tree
        for part in path.split("/"):
            node = node[part]
        a = np.array(node, dtype=np.float32)  # a writable copy
        if a.shape != tuple(shape):
            raise ValueError(
                f"JAX param {path} has shape {a.shape}, config expects {tuple(shape)}"
            )
        return torch.from_numpy(a)

    def mm(a: torch.Tensor) -> torch.Tensor:
        return a.to(cfg.param_dtype).contiguous()

    sd = {
        "embed.weight": mm(leaf("embed/embedding", (V, M))),
        "final_norm.weight": leaf("final_norm/scale", (M,)),
        "lm_head.weight": mm(leaf("lm_head/kernel", (M, V)).t()),
    }
    q = leaf("layers/attn/q_proj/kernel", (L, M, H, D))
    k = leaf("layers/attn/k_proj/kernel", (L, M, K, D))
    v = leaf("layers/attn/v_proj/kernel", (L, M, K, D))
    o = leaf("layers/attn/o_proj/kernel", (L, H * D, M))
    gate = leaf("layers/mlp/gate_proj/kernel", (L, M, Fd))
    up = leaf("layers/mlp/up_proj/kernel", (L, M, Fd))
    down = leaf("layers/mlp/down_proj/kernel", (L, Fd, M))
    attn_norm = leaf("layers/attn_norm/scale", (L, M))
    mlp_norm = leaf("layers/mlp_norm/scale", (L, M))
    for i in range(L):
        p = f"layers.{i}."
        sd[p + "attn_norm.weight"] = attn_norm[i].clone()
        sd[p + "mlp_norm.weight"] = mlp_norm[i].clone()
        sd[p + "attn.q_proj.weight"] = mm(q[i].reshape(M, H * D).t())
        sd[p + "attn.k_proj.weight"] = mm(k[i].reshape(M, K * D).t())
        sd[p + "attn.v_proj.weight"] = mm(v[i].reshape(M, K * D).t())
        sd[p + "attn.o_proj.weight"] = mm(o[i].t())
        sd[p + "mlp.gate_proj.weight"] = mm(gate[i].t())
        sd[p + "mlp.up_proj.weight"] = mm(up[i].t())
        sd[p + "mlp.down_proj.weight"] = mm(down[i].t())
    return sd
