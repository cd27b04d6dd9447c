"""Import HuggingFace-layout Llama weights into the port's ``Llama``, and
export them back — the port of ``pytorch_operator_tpu/models/llama_import.py``.

A state dict under HF's ``LlamaForCausalLM`` names
(``model.layers.N.self_attn.q_proj.weight`` …) maps one to one onto the
port's state-dict names (``models/convert.jax_leaves``). The port's
``nn.Linear`` weights are ``[out, in]`` like HF's, and its q/k/v weights are
``[heads·head_dim, d_model]`` with the head index outer (``JaxLeaf``'s
``"heads"`` layout), HF's layout too: unlike the reference's flax tree,
nothing is transposed, reshaped or stacked. Only the dtype changes: the
norm scales in float32, every other weight in ``cfg.param_dtype``, as
``convert.params_from_jax`` returns them.

RoPE: the port's ``apply_rope`` uses the rotate-half convention, the one
HF's modeling_llama applies, so projections import without the permutation
Meta's original interleaved checkpoints need.

The import takes live tensors (bf16 on the card included: each is cast on
its own device, never widened through the host) or numpy arrays (ml_dtypes'
bfloat16 included, reinterpreted without a copy).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from .convert import jax_leaves
from .llama import LlamaConfig

_HF_LAYER = {
    "attn_norm": "input_layernorm",
    "mlp_norm": "post_attention_layernorm",
    "attn": "self_attn",
    "mlp": "mlp",
}
_HF_TOP = {
    "embed.weight": "model.embed_tokens.weight",
    "final_norm.weight": "model.norm.weight",
    "lm_head.weight": "lm_head.weight",
}
_LAYER_NAME = re.compile(r"layers\.(\d+)\.(\w+)\.(.*)")


def _hf_name(name: str) -> str:
    """The HF state-dict name of the port's state-dict name ``name``."""
    if name in _HF_TOP:
        return _HF_TOP[name]
    i, module, rest = _LAYER_NAME.fullmatch(name).groups()
    return f"model.layers.{i}.{_HF_LAYER[module]}.{rest}"


def _port_shapes(cfg: LlamaConfig):
    """``(name, shape, norm)`` of every tensor of a dense Llama of ``cfg``,
    in ``jax_leaves`` order."""
    for leaf in jax_leaves(cfg):
        like = torch.empty(leaf.shape, device="meta")
        for i, name in enumerate(leaf.names):
            yield name, tuple(leaf.to_port(like, i).shape), leaf.norm


def _tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach()
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch's
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _refuse_moe(cfg: LlamaConfig, what: str) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            f"HF {what} for MoE configs is not implemented (dense Llama only)"
        )


def import_hf_llama_state_dict(sd: Dict[str, Any], cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """HF-layout state dict → the port's ``Llama`` state dict, each tensor on
    its source's device: the norm scales in float32, every other weight in
    ``cfg.param_dtype`` (a tensor already in its dtype is returned as it is,
    not copied). Without ``lm_head.weight`` (``tie_word_embeddings``
    checkpoints, e.g. Llama-3.2-1B/3B) the head is the embedding table.
    Raises KeyError naming a missing key and ValueError naming a wrong
    shape."""
    _refuse_moe(cfg, "import")
    out: Dict[str, torch.Tensor] = {}
    for name, shape, norm in _port_shapes(cfg):
        key = _hf_name(name)
        if key == "lm_head.weight" and key not in sd:
            key = "model.embed_tokens.weight"
        if key not in sd:
            raise KeyError(f"state_dict missing {key!r}")
        t = _tensor(sd[key])
        if tuple(t.shape) != shape:
            raise ValueError(f"{key}: expected shape {shape}, got {tuple(t.shape)}")
        out[name] = t.to(torch.float32 if norm else cfg.param_dtype).contiguous()
    return out


def export_hf_llama_state_dict(params, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`import_hf_llama_state_dict`: the port's state
    dict (or a ``Llama``) → an HF-layout state dict of float32 tensors on the
    parameters' device, each a new, writable, contiguous tensor (nothing
    aliases the model). Always writes ``lm_head.weight``. The round trip is
    exact wherever the values fit ``cfg.param_dtype``."""
    _refuse_moe(cfg, "export")
    if hasattr(params, "state_dict"):
        params = params.state_dict()
    return {
        _hf_name(name): params[name].detach().to(torch.float32, copy=True).contiguous()
        for name, _, _ in _port_shapes(cfg)
    }
