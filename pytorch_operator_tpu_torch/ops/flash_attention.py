"""Flash attention: hand-written Hopper kernels and their plain versions.

The counterpart of ``pytorch_operator_tpu/ops/flash_attention.py``: the
forward (``_fwd_kernel``) and the two backward kernels (``_dq_kernel``,
``_dkv_kernel``) behind a ``torch.autograd.Function``, as the JAX module puts
them behind a ``custom_vjp``. Same public layout — q ``[B,S,H,D]``, k and v
``[B,S,KH,D]`` with ``H % KH == 0`` (GQA) — and the same padding semantics:
a shape the kernels do not tile is zero-padded (S to the tile, D to a
supported head width), padded key columns are masked through ``kv_len``,
padded query rows and head columns are sliced off, and the softmax scale stays
``1/sqrt(true D)``. Gradients flow through the pad and the slice; padded query
rows get a zero output gradient, so they add nothing to dk and dv.

- A CUDA tensor goes to the kernels (``csrc/flash_fwd.cu``,
  ``csrc/flash_bwd.cu``, built at first use by ``_build.py``). A CUDA request
  a kernel cannot serve raises; nothing falls back.
- A CPU tensor goes to the plain versions: :func:`flash_attention_reference`
  (a dense masked softmax with the forward kernel's arithmetic: bf16 or f32
  products summed in f32, ``p`` cast to v's type before ``p·v``,
  ``lse = m + log l``) and :func:`flash_attention_backward_reference` (the
  backward kernels' arithmetic, densely: p recomputed from lse, ``ds`` and
  ``p`` cast to the input type before their products, dk and dv summed over
  the query heads of each kv head).
- A meta tensor (``ops/flop_count.py``'s counting run) launches nothing and
  runs no plain version: the wrapper records each kernel's FLOPs by
  :func:`kernel_flops` and returns empty outputs of the right shapes.

``launch_count``, ``dq_launch_count`` and ``dkv_launch_count`` count kernel
launches, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, flop_count

_NEG = -1e30  # finite mask value: exp(_NEG - m) underflows to exactly 0.0
KERNEL_TILE = 64  # the CUDA kernels take S in multiples of this (csrc/flash_*.cu)
KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_count = 0  # flash_fwd
dq_launch_count = 0  # flash_bwd_dq
dkv_launch_count = 0  # flash_bwd_dkv


def reset_launch_count() -> None:
    """Set all three kernels' launch counts to 0."""
    global launch_count, dq_launch_count, dkv_launch_count
    launch_count = dq_launch_count = dkv_launch_count = 0


def launch_counts() -> dict:
    """The three kernels' launch counts, by kernel name."""
    return {
        "flash_fwd": launch_count,
        "flash_bwd_dq": dq_launch_count,
        "flash_bwd_dkv": dkv_launch_count,
    }


def _plan_tiling(S: int, D: int, block_q: int, block_k: int, on_cuda: bool):
    """Resolve ``(block_q, block_k, S_pad, D_pad)`` for a possibly unaligned
    shape. On CUDA the kernels' unit of S (``KERNEL_TILE``) and their head
    widths (64, 128) set the padding; the requested blocks do not change it. On the CPU the plain
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
    s = s.masked_fill(~_keep_mask(S, causal, kv_len, q.device), _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # [B,KH,G,S,1], from the f32 p
    pv = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).float(), v.float())
    o = (pv / l.permute(0, 3, 1, 2, 4)).to(q.dtype).reshape(B, S, H, D)
    lse = (m + torch.log(l)).reshape(B * H, S)
    return o, lse


def _keep_mask(S: int, causal: bool, kv_len: int, device) -> torch.Tensor:
    """``_mask_scores``'s rule as a [S, S] bool (row = query, col = key)."""
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    keep = cols < kv_len
    if causal:
        keep = keep & (cols <= rows)
    return keep


def flash_attention_backward_reference(q, k, v, o, lse, do, *, causal: bool, kv_len: int,
                                       scale: float):
    """The plain version of the two backward kernels on padded ``[B,S,H,D]``
    / ``[B,S,KH,D]`` inputs, ``o`` the forward's output, ``lse`` its ``[B*H,
    S]`` f32 log-sum-exp and ``do`` the output gradient. Repeats the kernels'
    arithmetic densely: ``p = exp(s - lse)``, ``delta = rowsum(do·o)``,
    ``ds = p·(dp - delta)``, ``ds`` and ``p`` cast to the input dtype before
    ``ds·k``, ``dsᵀ·q`` and ``pᵀ·do``, every product summed in f32, and dk/dv
    summed over the G query heads of each kv head. Returns ``(dq, dk, dv)``
    in q's, k's and v's dtypes."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, S, KH, G, D).float()
    dog = do.reshape(B, S, KH, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    s = s.masked_fill(~_keep_mask(S, causal, kv_len, q.device), _NEG)
    p = torch.exp(s - lse.reshape(B, KH, G, S, 1))
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    delta = (do.float() * o.float()).sum(-1).reshape(B, S, KH, G).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds.to(q.dtype).float(), qg) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p.to(do.dtype).float(), dog)
    return dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# How far a backward kernel's gradient may stray from its plain version, as a
# relative L2 error over the whole tensor and its late half (GRAD_RTOL) and in
# its worst row (ROW_RTOL): bf16 rounds each output once (one step is 2**-8 of
# the value) and may round p, ds and the forward's o the other way where they
# differ in the last f32 bits, and a row's 64-128 values average less of that
# away; f32 only sums in another order.
GRAD_RTOL = {torch.bfloat16: 5e-3, torch.float32: 1e-4}
ROW_RTOL = {torch.bfloat16: 3e-2, torch.float32: 3e-4}


def grad_agreement(g: torch.Tensor, r: torch.Tensor, seq_len: int) -> dict:
    """How gradient ``g`` (``[B, S, heads, D]``; also the forward's o, see
    :func:`forward_agreement`) strays from its plain version ``r``, at scales
    that follow the values (under a causal mask the first keys' gradients are
    50-100x the rest, so one tolerance scaled to the largest value passes a
    wrong late half):

    - ``max_abs``: the largest element error, for the record;
    - ``rel``: ``|g - r| / |r|`` (L2) over the whole tensor;
    - ``rel_late``: the same over positions ``seq_len // 2 .. seq_len``;
    - ``rel_row``: the worst row (one position of one head), its error over
      its own norm plus a tenth of the mean row norm (a row that should be
      zero has to stay near zero; a row that is small by cancellation may
      differ by more than its own size).

    ``ok`` when ``rel`` and ``rel_late`` are within ``GRAD_RTOL`` and
    ``rel_row`` within ``ROW_RTOL``."""
    d, r32 = g.float() - r.float(), r.float()

    def rel(a, b):
        na, nb = torch.linalg.vector_norm(a).item(), torch.linalg.vector_norm(b).item()
        return na / nb if nb > 0 else (0.0 if na == 0 else math.inf)

    late = slice(seq_len // 2, seq_len)
    row_err, row_ref = (torch.linalg.vector_norm(x, dim=-1) for x in (d, r32))
    floor = max(0.1 * row_ref.mean().item(), torch.finfo(torch.float32).tiny)
    out = {
        "max_abs": d.abs().max().item(),
        "rel": rel(d, r32),
        "rel_late": rel(d[:, late], r32[:, late]),
        "rel_row": (row_err / (row_ref + floor)).max().item(),
    }
    out["ok"] = (
        max(out["rel"], out["rel_late"]) <= GRAD_RTOL[g.dtype]
        and out["rel_row"] <= ROW_RTOL[g.dtype]
    )
    return out


# The forward's largest absolute error of o and of lse: bf16 rounds p before
# p·v and the plain version sums in another order; f32 with TF32 off.
FWD_ATOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}


def forward_agreement(o, lse, o_ref, lse_ref, seq_len: int) -> dict:
    """How the forward's ``(o, lse)`` stray from their plain version. Under a
    causal mask a late row's o is about ``sqrt(e / row)`` of the first rows',
    so an absolute tolerance sized for those passes a wrong late tile: o is
    held by :func:`grad_agreement` (relative L2 over the whole tensor, its
    late half and its worst row) and, with lse, by its largest absolute error
    (``FWD_ATOL``). Returns ``grad_agreement``'s readings of o plus
    ``lse_max_abs``; ``ok`` when every check holds."""
    out = grad_agreement(o, o_ref, seq_len)
    out["lse_max_abs"] = (lse.float() - lse_ref.float()).abs().max().item()
    out["ok"] = out["ok"] and max(out["max_abs"], out["lse_max_abs"]) <= FWD_ATOL[o.dtype]
    return out


def _aligned(x: torch.Tensor) -> bool:
    """The bf16 kernels read their tiles by TMA: base and the B, S and head
    strides must be multiples of 16 bytes (8 elements)."""
    return x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:3])


def _kernel_inputs(*xs):
    """Check dtype and layout for the kernels; return the tensors with a
    contiguous last dim (and 16-byte-aligned rows for bf16)."""
    dt = xs[0].dtype
    if dt not in _KERNEL_DTYPES or any(x.dtype != dt for x in xs):
        raise TypeError(
            "flash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
            + "/".join(str(x.dtype) for x in xs)
        )
    out = []
    for x in xs:
        if x.stride(-1) != 1 or (dt == torch.bfloat16 and not _aligned(x)):
            x = x.contiguous()
        out.append(x)
    return out


def _strides(*xs):
    return [st for x in xs for st in x.stride()[:3]]


_libs = {}


def _kernel_lib(name: str):
    """The ctypes library of kernel source ``name``, built and bound at first
    use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
        tail = [i32] * 7 + [f32, i32, ptr]
        if name == "flash_fwd":
            lib.flash_fwd.argtypes = [ptr] * 5 + [i64] * 12 + tail
            lib.flash_fwd.restype = i32
        else:
            lib.flash_bwd_dq.argtypes = [ptr] * 7 + [i64] * 15 + tail
            lib.flash_bwd_dq.restype = i32
            lib.flash_bwd_dkv.argtypes = [ptr] * 8 + [i64] * 18 + tail
            lib.flash_bwd_dkv.restype = i32
            lib.flash_bwd_dkv_smem.argtypes = [i32]
            lib.flash_bwd_dkv_smem.restype = ctypes.c_longlong
        _libs[name] = lib
    return lib


def _check_padded(q, k):
    B, S, H, D = q.shape
    if D not in KERNEL_HEAD_DIMS or S % KERNEL_TILE:
        raise ValueError(f"unpadded shape S={S}, D={D} reached the kernel")
    return B, S, H, D, k.shape[2]


def _launch(q, k, v, *, causal: bool, kv_len: int, scale: float):
    """Launch the forward kernel on padded inputs; raise on anything it
    cannot serve. Returns ``(o, lse)`` like :func:`flash_attention_reference`."""
    global launch_count
    q, k, v = _kernel_inputs(q, k, v)
    B, S, H, D, KH = _check_padded(q, k)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    lib = _kernel_lib("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            *_strides(q, k, v, o),
            B, H, H // KH, S, D, kv_len, int(causal), scale,
            _KERNEL_DTYPES[q.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return o, lse


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(do·o)`` as ``[B*H, S]`` f32: one reduction outside
    the kernels, as the JAX package computes it outside its kernels."""
    B, S, H, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(B * H, S).contiguous()


def _bwd_call(entry: str, q, k, v, do, lse, delta, outs, *, causal, kv_len, scale):
    B, S, H, D, KH = _check_padded(q, k)
    lib = _kernel_lib("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(x.data_ptr() for x in outs), *_strides(q, k, v, do, *outs),
            B, H, H // KH, S, D, kv_len, int(causal), scale, _KERNEL_DTYPES[q.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")


def _launch_dq(q, k, v, do, lse, delta, *, causal: bool, kv_len: int, scale: float):
    """Launch ``flash_bwd_dq`` on padded, kernel-ready inputs (see
    :func:`_launch_bwd`); returns dq."""
    global dq_launch_count
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_call("flash_bwd_dq", q, k, v, do, lse, delta, (dq,),
              causal=causal, kv_len=kv_len, scale=scale)
    dq_launch_count += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, *, causal: bool, kv_len: int, scale: float):
    """Launch ``flash_bwd_dkv`` on padded, kernel-ready inputs (see
    :func:`_launch_bwd`); returns ``(dk, dv)``, summed over each kv head's
    query heads."""
    global dkv_launch_count
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_call("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv),
              causal=causal, kv_len=kv_len, scale=scale)
    dkv_launch_count += 1
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, *, causal: bool, kv_len: int, scale: float):
    """Launch the two backward kernels on padded inputs; raise on anything
    they cannot serve. Returns ``(dq, dk, dv)`` like
    :func:`flash_attention_backward_reference`."""
    q, k, v, do = _kernel_inputs(q, k, v, do.contiguous())
    args = (q, k, v, do, lse.contiguous(), bwd_delta(o, do))
    kw = dict(causal=causal, kv_len=kv_len, scale=scale)
    dq = _launch_dq(*args, **kw)
    dk, dv = _launch_dkv(*args, **kw)
    return dq, dk, dv


LANES = 128  # the reference's lse, m and l blocks carry a 128-lane dim


def kernel_flops(kernel: str, *, B: int, H: int, KH: int, S: int, D: int, block_q: int,
                 block_k: int, causal: bool, kv_masked: bool) -> dict:
    """FLOPs of one call of ``kernel`` (``flash_fwd``, ``flash_bwd_dq``,
    ``flash_bwd_dkv``) on padded ``[B, S, H, D]`` inputs, by the counting
    rule of ``ops/flop_count.py``: JAX's ``pallas_call`` rule, the kernel
    body's FLOPs times the grid ``(B·H, S/block_q, S/block_k)``, whatever
    runs the call. The body's counts are those of the reference's
    ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` (every ``pl.when``
    branch counted, as the reference's walker takes a cond's larger branch;
    its ref reads ``get`` and writes ``swap`` at one a element; the
    ``_mask_scores`` and ``_live_block`` terms where ``causal`` or the
    ``kv_len`` mask ``kv_masked`` apply). dkv's sum over each kv head's G
    query heads, inside this port's kernel and after the reference's, adds
    its ``reduce_sum``."""
    bq, bk, P = block_q, block_k, block_q * block_k
    if kernel == "flash_fwd":
        c = {"dot_general": 4 * P * D, "mul": P + bq + bq * D, "sub": P + bq, "exp": P + bq,
             "add": 2 * bq + bq * D, "div": bq * D, "log": bq, "max": bq, "reduce_max": bq,
             "reduce_sum": bq, "get": 3 * bq * D + 2 * bk * D + 4 * bq,
             "swap": 5 * bq * LANES + 3 * bq * D}
    elif kernel == "flash_bwd_dq":
        c = {"dot_general": 6 * P * D, "mul": 2 * P + bq * D, "sub": 2 * P, "exp": P,
             "add": bq * D, "get": 4 * bq * D + 2 * bk * D + 2 * bq, "swap": 3 * bq * D}
    elif kernel == "flash_bwd_dkv":
        c = {"dot_general": 8 * P * D, "mul": 2 * P + bk * D, "sub": 2 * P, "exp": P,
             "add": 2 * bk * D, "get": 2 * bq * D + 6 * bk * D + 2 * bq, "swap": 6 * bk * D}
    else:
        raise ValueError(f"no kernel {kernel!r}")
    c.update(eq=2, program_id=2)

    def more(name, n):
        c[name] = c.get(name, 0) + n

    if causal or kv_masked:  # the row and column indices of the block
        more("add", 2 * P)
        more("mul", 2)
    if causal:
        more("le", P + 1)
        more("mul", 2)
        more("add", 1)
        more("sub", 1)
    if kv_masked:
        more("lt", P + 1)
        more("mul", 1)
        more("and", P + int(causal))
    cells = B * H * (S // bq) * (S // bk)
    out = {k: float(v * cells) for k, v in c.items()}
    if kernel == "flash_bwd_dkv" and H != KH:
        out["reduce_sum"] = 2.0 * B * KH * S * D
    return out


def _count_call(kernel: str, q, k, tiling: dict) -> None:
    c = flop_count.counter()
    if c is not None:
        B, S, H, D = q.shape
        c.kernel(kernel, kernel_flops(kernel, B=B, H=H, KH=k.shape[2], S=S, D=D, **tiling))


def _count_fwd(q, k, tiling: dict):
    """The forward on meta tensors: its FLOPs recorded, nothing run."""
    _count_call("flash_fwd", q, k, tiling)
    B, S, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B * H, S), dtype=torch.float32)


def _count_bwd(q, k, v, o, do, tiling: dict):
    """The backward on meta tensors: delta (outside the kernels, as on the
    card) and both kernels' FLOPs recorded, nothing run."""
    bwd_delta(o, do)
    _count_call("flash_bwd_dq", q, k, tiling)
    _count_call("flash_bwd_dkv", q, k, tiling)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with the flash backward, on unpadded ``[B,S,H,D]`` /
    ``[B,S,KH,D]`` inputs; ``apply(q, k, v, causal, kv_len, block_q,
    block_k)`` returns ``(o, lse)``. Forward pads, runs the forward kernel
    (CUDA) or :func:`flash_attention_reference` (CPU) and saves the padded
    q, k, v, o and the ``[B*H, S_pad]`` lse — the JAX residual without its
    128-lane broadcast. Backward pads ``do`` the same way and runs the two
    backward kernels (CUDA) or :func:`flash_attention_backward_reference`
    (CPU), then slices the padding off. lse is not differentiable. On meta
    tensors it counts (``_count_fwd``, ``_count_bwd``) with the CPU's
    tiling, the reference's."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_len, block_q, block_k):
        B, S, H, D = q.shape
        on_cuda = q.device.type == "cuda"
        bq, bk, S_pad, D_pad = _plan_tiling(S, D, block_q, block_k, on_cuda)
        if S_pad != S and kv_len is None:
            kv_len = S  # padded key columns must not attend
        tiling = dict(block_q=bq, block_k=bk, causal=causal, kv_masked=kv_len is not None)
        kv_len = S_pad if kv_len is None else kv_len
        scale = 1.0 / math.sqrt(D)
        pad = (0, D_pad - D, 0, 0, 0, S_pad - S)
        if S_pad != S or D_pad != D:
            q, k, v = (F.pad(x, pad) for x in (q, k, v))
        if q.is_meta:
            o, lse = _count_fwd(q, k, tiling)
        else:
            run = _launch if on_cuda else flash_attention_reference
            o, lse = run(q, k, v, causal=causal, kv_len=kv_len, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(causal=causal, kv_len=kv_len, scale=scale)
        ctx.tiling = tiling
        ctx.pad, ctx.S, ctx.D = pad, S, D
        lse_out = lse[:, :S]
        ctx.mark_non_differentiable(lse_out)
        return o[:, :S, :, :D], lse_out

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        S, D = ctx.S, ctx.D
        do = F.pad(do, ctx.pad) if do.shape != o.shape else do
        if q.is_meta:
            dq, dk, dv = _count_bwd(q, k, v, o, do, ctx.tiling)
        else:
            run = _launch_bwd if q.device.type == "cuda" else flash_attention_backward_reference
            dq, dk, dv = run(q, k, v, o, lse, do, **ctx.args)
        return (
            dq[:, :S, :, :D], dk[:, :S, :, :D], dv[:, :S, :, :D], None, None, None, None,
        )


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
    """Flash attention returning ``(o [B,S,H,D], lse [B*H, S] f32)``;
    differentiable in q, k and v (not through lse).

    ``kv_len``: one true sequence length for the whole batch; keys at
    positions >= kv_len are masked out. ``block_q``/``block_k`` are the JAX
    wrapper's knobs: they shape the padding of the CPU path, while the CUDA
    kernels pad S to a multiple of 64 (see :func:`_plan_tiling`).
    """
    B, S, H, D = q.shape
    KH = k.shape[2]
    if k.shape != (B, S, KH, D) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % KH:
        raise ValueError(f"H={H} not a multiple of KH={KH}")
    if kv_len is not None and not 0 < kv_len <= S:
        raise ValueError(f"kv_len={kv_len} outside (0, S={S}]")
    if q.device.type not in ("cuda", "cpu", "meta") or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"q/k/v on {q.device}/{k.device}/{v.device}: the kernel takes CUDA "
            "tensors, the plain version CPU tensors and the FLOP count meta "
            "tensors, all on one device"
        )
    return FlashAttentionFunction.apply(q, k, v, causal, kv_len, block_q, block_k)


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 1024,
                    block_k: int = 1024, kv_len: Optional[int] = None):
    """Blockwise attention, ``[B,S,H,D]`` out in q's dtype (see
    :func:`flash_attention_with_lse`)."""
    return flash_attention_with_lse(
        q, k, v, causal=causal, block_q=block_q, block_k=block_k, kv_len=kv_len
    )[0]
