"""Weights and tokens drawn from a run's seed, the same for the port and the
reference.

The weights of a Mistral-shaped decoder are drawn in groups: the embedding,
each layer's seven matrices, the LM head. A group is one flat f32 buffer
filled by one ``normal_`` call of its own generator, so that any one group
can be drawn again alone (the parameters' change after the checked steps is
measured against the start, drawn again group by group). Every matrix and
the embedding are N(0, initializer_range²), as the source's ``_init_weights``;
the RMSNorm scales are ones.

Names and shapes are those of the port's ``Llama`` state dict (``[out,
in]`` weights); the reference uses the same dict.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

# Generators are seeded seed·_STRIDE + group; the tokens take the last slot.
_STRIDE = 4096
_TOKENS = _STRIDE - 1


def _gen(seed: int, slot: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed % 2**50) * _STRIDE + slot)


def groups(cfg: dict) -> List[List[Tuple[str, Tuple[int, ...]]]]:
    """The drawn groups, each a list of ``(name, shape)`` in draw order."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    H, KH, Dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    V, L = cfg["vocab_size"], cfg["num_hidden_layers"]
    out = [[("embed.weight", (V, D))]]
    for i in range(L):
        p = f"layers.{i}."
        out.append([
            (p + "attn.q_proj.weight", (H * Dh, D)),
            (p + "attn.k_proj.weight", (KH * Dh, D)),
            (p + "attn.v_proj.weight", (KH * Dh, D)),
            (p + "attn.o_proj.weight", (D, H * Dh)),
            (p + "mlp.gate_proj.weight", (F, D)),
            (p + "mlp.up_proj.weight", (F, D)),
            (p + "mlp.down_proj.weight", (D, F)),
        ])
    out.append([("lm_head.weight", (V, D))])
    if len(out) >= _TOKENS:
        raise ValueError(f"{len(out)} weight groups do not fit the seed stride {_STRIDE}")
    return out


def norm_names(cfg: dict) -> List[str]:
    """The RMSNorm scales (ones at the start)."""
    L = cfg["num_hidden_layers"]
    names = [f"layers.{i}.{n}.weight" for i in range(L) for n in ("attn_norm", "mlp_norm")]
    return names + ["final_norm.weight"]


def draw_group(cfg: dict, seed: int, g: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Group ``g``'s tensors, f32 views of one freshly drawn buffer."""
    spec = groups(cfg)[g]
    n = sum(torch.Size(s).numel() for _, s in spec)
    flat = torch.empty(n, dtype=torch.float32, device=device)
    flat.normal_(0.0, cfg["initializer_range"], generator=_gen(seed, g, device))
    off = 0
    for name, shape in spec:
        k = torch.Size(shape).numel()
        yield name, flat[off:off + k].view(shape)
        off += k


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, f32, on ``device``."""
    out = {}
    for g in range(len(groups(cfg))):
        for name, t in draw_group(cfg, seed, g, device):
            out[name] = t.clone()
    for name in norm_names(cfg):
        out[name] = torch.ones(cfg["hidden_size"], dtype=torch.float32, device=device)
    return out


@torch.no_grad()
def load_into(named: Dict[str, torch.Tensor], cfg: dict, seed: int) -> None:
    """Copy the seed's weights into ``named`` (name → parameter), group by
    group; every name of :func:`groups` and :func:`norm_names` must be
    there."""
    for g in range(len(groups(cfg))):
        dev = named["embed.weight"].device
        for name, t in draw_group(cfg, seed, g, dev):
            named[name].copy_(t)
    for name in norm_names(cfg):
        named[name].fill_(1.0)


@torch.no_grad()
def change_norms(named: Dict[str, torch.Tensor], cfg: dict, seed: int) -> Dict[str, torch.Tensor]:
    """Per drawn tensor, ``‖p − p0‖`` (a device scalar), p0 drawn again;
    per norm scale ``‖p − 1‖``."""
    out = {}
    for g in range(len(groups(cfg))):
        dev = named["embed.weight"].device
        for name, t0 in draw_group(cfg, seed, g, dev):
            out[name] = torch.linalg.vector_norm(named[name].float() - t0)
    for name in norm_names(cfg):
        out[name] = torch.linalg.vector_norm(named[name].float() - 1.0)
    return out


def tokens(cfg: dict, mix: dict, seed: int, device) -> torch.Tensor:
    """The feed's pool: ``[pool, B, S]`` int64 ids, uniform over the
    vocabulary, drawn on ``device``."""
    shape = (mix["pool"], mix["batch"], mix["seq_len"])
    return torch.randint(0, cfg["vocab_size"], shape, generator=_gen(seed, _TOKENS, device),
                         device=device)
