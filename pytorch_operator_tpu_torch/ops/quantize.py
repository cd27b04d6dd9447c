"""Weight-only int8 quantization for the serving path — the port of
``pytorch_operator_tpu/ops/quantize.py``.

Symmetric per-channel int8: ``w ≈ f32(q) * scale`` with ``scale =
max|w| / 127`` over the channel, ``q`` rounded half to even and clipped to
±127. The same function quantizes the int8 KV cache per (token, kv head)
over ``head_dim`` (``models/llama.py``).

The port holds its dense weights ``[out, in]`` (``nn.Linear``), so the JAX
rule (``contract_axis``: one scale per output channel, over the axis the
matmul reduces) is one scale per row, over ``dim=-1``, for every
``*_proj.weight`` and ``lm_head.weight``; the embedding keeps one scale per
vocabulary row, also over ``dim=-1``. The MoE expert banks keep the
reference's ``[E, in, out]`` layout and its rule: over ``dim=-2``, one scale
per output column (``[E, 1, out]``). Norm weights and the MoE router stay
full precision. A quantized state dict holds each such weight as int8 ``q``
and adds its scale (f32): ``<module>.scale`` ``[out, 1]`` beside a
``<module>.weight``, ``<bank>_scale`` beside a bank.

The reference dequantizes inside its compiled program, where XLA fuses the
``convert(s8) * scale`` into the matmul's operand read. Eager PyTorch has no
such fusion: :func:`dequantize` writes the dequantized weight once, in the
dtype the matmul takes, one layer at a time at the use site, so no
full-precision copy of the model stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch


@dataclasses.dataclass
class QuantizedTensor:
    """An int8-quantized tensor: ``q`` keeps the original shape, ``scale`` is
    f32 of the same rank with extent 1 along the quantized dim."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return dequantize(self.q, self.scale, dtype)


def quantize(w: torch.Tensor, dim: int) -> QuantizedTensor:
    """Symmetric per-channel int8 over ``dim``: scale = max|w| / 127.

    Both quotients are true divisions, as in the reference's op-by-op
    arithmetic: the 127 is a tensor on ``w``'s device, because CUDA's ``div``
    by a Python scalar multiplies by its reciprocal instead."""
    w32 = w.float()
    amax = w32.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(torch.finfo(torch.float32).tiny) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return QuantizedTensor(q=q.to(torch.int8), scale=scale)


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(f32(q) * scale)`` rounded once to ``dtype``, in one kernel: the
    product runs in f32 and only the result is written, in ``dtype``."""
    return torch.mul(q, scale, out=torch.empty(q.shape, dtype=dtype, device=q.device))


def quant_dim(name: str) -> Optional[int]:
    """The dim over which the rule quantizes a state-dict entry, or None to
    keep it in full precision: ``contract_axis`` on the port's names."""
    if name in ("embed.weight", "lm_head.weight") or name.endswith("_proj.weight"):
        return -1
    if name.endswith(("moe_mlp.w_in", "moe_mlp.w_out")):
        return -2
    return None


def is_quantized(name: str) -> bool:
    """Whether the rule quantizes a state-dict entry."""
    return quant_dim(name) is not None


def scale_name(name: str) -> str:
    """``<module>.weight`` -> ``<module>.scale``; a bank ``<...>.w_in`` ->
    ``<...>.w_in_scale``."""
    if name.endswith("weight"):
        return name[: -len("weight")] + "scale"
    return name + "_scale"


def quantize_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The int8 state dict of a full-precision one: each weight the rule
    names becomes its int8 ``q`` plus a ``<module>.scale`` entry; the other
    entries pass through. Quantizes on the tensors' own device."""
    out = {}
    for name, w in sd.items():
        dim = quant_dim(name)
        if dim is None:
            out[name] = w
            continue
        qt = quantize(w, dim)
        out[name], out[scale_name(name)] = qt.q, qt.scale
    return out


def state_bytes(sd: Mapping[str, torch.Tensor]) -> int:
    """Payload bytes of a state dict (``tree_bytes``): ``q`` plus scale
    bytes for each quantized weight, plus the full-precision entries."""
    return sum(t.numel() * t.element_size() for t in sd.values())
