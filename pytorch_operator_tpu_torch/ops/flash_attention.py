"""Flash attention forward: a hand-written Hopper kernel and its plain version.

The counterpart of ``pytorch_operator_tpu/ops/flash_attention.py``'s forward
(``_fwd_kernel``). Same public layout — q ``[B,S,H,D]``, k and v
``[B,S,KH,D]`` with ``H % KH == 0`` (GQA) — and the same padding semantics:
a shape the kernel does not tile is zero-padded (S to the tile, D to a
supported head width), padded key columns are masked through ``kv_len``,
padded query rows and head columns are sliced off, and the softmax scale stays
``1/sqrt(true D)``.

- A CUDA tensor goes to the kernel (``csrc/flash_fwd.cu``, built at first use
  by ``_build.py``). A CUDA request the kernel cannot serve raises; nothing
  falls back.
- A CPU tensor goes to :func:`flash_attention_reference`, a dense masked
  softmax with the kernel's arithmetic: bf16 (or f32) products summed in f32,
  ``p`` cast to v's type before ``p·v``, ``lse = m + log l``.

``launch_count`` counts kernel launches, so a run can show that its main path
went through the kernel. Backward kernels (the TPU's ``_dq_kernel`` and
``_dkv_kernel``) come with the training slice, behind an
``autograd.Function``; this module is forward only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_NEG = -1e30  # finite mask value: exp(_NEG - m) underflows to exactly 0.0
KERNEL_TILE = 64  # the CUDA kernel's query and key tile (csrc/flash_fwd.cu)
KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _plan_tiling(S: int, D: int, block_q: int, block_k: int, on_cuda: bool):
    """Resolve ``(block_q, block_k, S_pad, D_pad)`` for a possibly unaligned
    shape. On CUDA the kernel's 64x64 tile and its head widths (64, 128) set
    the padding; the requested blocks do not change it. On the CPU the plain
    version needs no tiling, and the blocks pad S as the JAX wrapper does in
    interpret mode (unequal blocks where neither divides the other collapse to
    the smaller one)."""
    if on_cuda:
        D_pad = next((d for d in KERNEL_HEAD_DIMS if D <= d), None)
        if D_pad is None:
            raise ValueError(
                f"head dim {D} > {KERNEL_HEAD_DIMS[-1]}: the flash kernel "
                f"supports D in {KERNEL_HEAD_DIMS} (smaller D is zero-padded)"
            )
        tile = KERNEL_TILE
        return tile, tile, -(-S // tile) * tile, D_pad
    block_q, block_k = min(block_q, S), min(block_k, S)
    lcm = block_q * block_k // math.gcd(block_q, block_k)
    if lcm > max(block_q, block_k):
        lcm = block_q = block_k = min(block_q, block_k)
    return block_q, block_k, -(-S // lcm) * lcm, D


def flash_attention_reference(q, k, v, *, causal: bool, kv_len: int, scale: float):
    """The plain version of the kernel on ``[B,S,H,D]`` / ``[B,S,KH,D]``
    inputs (already padded): a dense masked softmax. Returns ``(o, lse)``
    with o in q's dtype and lse ``[B*H, S]`` float32."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, S, KH, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    keep = cols < kv_len
    if causal:
        keep = keep & (cols <= rows)
    s = s.masked_fill(~keep, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # [B,KH,G,S,1], from the f32 p
    pv = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).float(), v.float())
    o = (pv / l.permute(0, 3, 1, 2, 4)).to(q.dtype).reshape(B, S, H, D)
    lse = (m + torch.log(l)).reshape(B * H, S)
    return o, lse


def _aligned(x: torch.Tensor) -> bool:
    """The bf16 kernel moves rows as 16-byte vectors: base and the B, S and
    head strides must be multiples of 8 elements."""
    return x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:3])


def _bind(lib):
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.flash_fwd.argtypes = (
        [ptr] * 5 + [i64] * 12 + [i32] * 7 + [ctypes.c_float, i32, ptr]
    )
    lib.flash_fwd.restype = i32
    return lib


_lib = None


def _launch(q, k, v, *, causal: bool, kv_len: int, scale: float):
    """Launch the CUDA kernel on padded inputs; raise on anything it cannot
    serve. Returns ``(o, lse)`` like :func:`flash_attention_reference`."""
    global _lib, launch_count
    if q.dtype not in _KERNEL_DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    B, S, H, D = q.shape
    KH = k.shape[2]
    if D not in KERNEL_HEAD_DIMS or S % KERNEL_TILE:
        raise ValueError(f"unpadded shape S={S}, D={D} reached the kernel")
    ins = []
    for x in (q, k, v):
        if x.stride(-1) != 1 or (x.dtype == torch.bfloat16 and not _aligned(x)):
            x = x.contiguous()
        ins.append(x)
    q, k, v = ins
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    if _lib is None:
        _lib = _bind(_build.load("flash_fwd"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            B, H, H // KH, S, D, kv_len, int(causal), scale,
            _KERNEL_DTYPES[q.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return o, lse


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: int = 1024,
    block_k: int = 1024,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention returning ``(o [B,S,H,D], lse [B*H, S] f32)``.

    ``kv_len``: one true sequence length for the whole batch; keys at
    positions >= kv_len are masked out. ``block_q``/``block_k`` are the JAX
    wrapper's knobs: they shape the padding of the CPU path, while the CUDA
    kernel's tile is fixed at 64x64 (see :func:`_plan_tiling`).
    """
    B, S, H, D = q.shape
    KH = k.shape[2]
    if k.shape != (B, S, KH, D) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % KH:
        raise ValueError(f"H={H} not a multiple of KH={KH}")
    if kv_len is not None and not 0 < kv_len <= S:
        raise ValueError(f"kv_len={kv_len} outside (0, S={S}]")
    dev = q.device.type
    if dev not in ("cuda", "cpu") or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"q/k/v on {q.device}/{k.device}/{v.device}: the kernel takes CUDA "
            "tensors and the plain version CPU tensors, all on one device"
        )
    on_cuda = dev == "cuda"
    _, _, S_pad, D_pad = _plan_tiling(S, D, block_q, block_k, on_cuda)
    if S_pad != S and kv_len is None:
        kv_len = S  # padded key columns must not attend
    kv_len = S_pad if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(D)
    if S_pad != S or D_pad != D:
        pad = (0, D_pad - D, 0, 0, 0, S_pad - S)
        q, k, v = (F.pad(x, pad) for x in (q, k, v))
    run = _launch if on_cuda else flash_attention_reference
    o, lse = run(q, k, v, causal=causal, kv_len=kv_len, scale=scale)
    return o[:, :S, :, :D], lse[:, :S]


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 1024,
                    block_k: int = 1024, kv_len: Optional[int] = None):
    """Blockwise attention, ``[B,S,H,D]`` out in q's dtype (see
    :func:`flash_attention_with_lse`)."""
    return flash_attention_with_lse(
        q, k, v, causal=causal, block_q=block_q, block_k=block_k, kv_len=kv_len
    )[0]
