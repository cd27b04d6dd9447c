"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. Card identity (``nvidia-smi`` name and power limit), then the build of
   every kernel source with nvcc (all at once), with its time and ptxas's
   registers and spills for each kernel, and the bf16 dkv's dynamic shared
   memory; a ptxas note that it serialised a kernel's ``wgmma``s (C7520)
   fails the run.
2. The forward kernel against its plain PyTorch version on the card, in the
   listed cases, by ``forward_agreement`` (o by relative L2 error over the
   whole tensor, its late half and per row; o and lse by their largest
   absolute error); kernel, plain-version and library
   (``scaled_dot_product_attention``, timed only) times at the generate
   prefill's shape and at the training shape, with achieved TFLOP/s and the
   wrapper's host time a call.
3. The two backward kernels against their plain version
   (``flash_attention_backward_reference``) on the same padded inputs, in the
   listed cases, by ``grad_agreement`` (relative L2 error over the whole
   gradient, over its late half and per row); at the training shape each
   kernel's time and host time a call, the plain backward's, SDPA's backward
   (timed only) and each bound. Then the bf16 gradients of the public, differentiable
   ``flash_attention`` on the card against the plain forward and backward, at
   the training shape and at a padded one.
4. The generate path: ``workloads.generate.run`` at ``llama_0_3b`` full
   width and depth (batch 8, 512-token prompt, 32 new tokens, random weights
   from a seed), launch counts set to 0 just before and read just after (the
   forward kernel once per layer per prefill); the flash prefill's logits
   against the dense model's; a profile of one generate call (run after
   phase 6: no timed run follows a profiler session).
5. The training path: ``workloads.llama_train.run`` at ``llama_0_3b`` full
   width and depth (batch 4 x 4096 tokens, 1 warmup + 5 steps, AdamW, random
   weights from a seed), launch counts set to 0 just before and read just
   after (each of the three kernels once per layer per step; finite losses,
   the last below the first); one step of flash + chunked loss against dense
   attention + dense loss on the same weights (batch 4 x 1024: the loss, the
   global gradient norm and each layer's q/k/v projection gradients); a
   profile of one training step (run after phase 6).
6. The serve path, at ``llama_0_3b`` full width and depth (random weights
   from a seed, bf16 weights and cache; 8 slots, chunk 128, block 64,
   ``max_decode_len`` 4096): (a) ``workloads.serve.run`` over the file
   spool, fed by a client thread with the engine stream that bench.py
   times (a warmup pair left out of the stats, then 24 requests of prompts
   64-511 and 64-191 new tokens, sent at once), launch counts set to 0 just
   before and read just after (the engine prefills and decodes through the
   cache attention, as the JAX engine does: no flash launch); every
   response whole and in the vocabulary, none rejected; the engine's decode
   tokens/s, TTFT (from submit, and from admission) and TPOT percentiles;
   every emitted token held by teacher forcing on the same weights against
   the prompt serve.run synthesised for its id: the dense model's logits
   over prompt + emitted tokens, the chosen token within ``LOGITS_TOL`` of
   each position's largest logit, and the exact argmax at no less than
   ``SERVE_EXACT_SHARE_MIN`` of the positions; (b) a ``ServingEngine`` on
   the same weights driven directly with edge requests (a prompt of one
   chunk, one a token into a second chunk, one at the cache budget, a
   single-token request, more requests than slots), held the same way;
   (c) the admission of 8 prompts (prefill time a chunk), a decode block
   timed, then profiled (the card's busy share, kernel launches per decode
   step, host ops by host time), then timed again after the profiler
   session.
7. One ``{"kernels": [...]}`` line, the card's line, and as the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import math
import re
import subprocess
import sys
import time


def _fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def _log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and dense
# bf16 / float32 (non-tensor-core) operations per second.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# (name, B, S, H, KH, D, causal, kv_len, dtype): the generate prefill shape
# first and the training shape second — both are timed; the first's numbers
# are the forward's in the kernels line. The edge cases meet the bf16
# kernels' tiles (128 query rows a forward or dq CTA, 128 keys a dkv CTA of
# two 64-key warpgroups; 128 keys a forward tile, 64 a dq tile, 64 query rows
# a dkv tile): S 192 leaves the last query tile, and the last dkv CTA's
# second warpgroup, past S; S 64 is one tile smaller than a CTA's rows;
# kv_len 77 ends inside a key tile; G 8 is dkv's longest walk over query
# heads; causal kv_len 100 ends inside a dkv CTA's second warpgroup; kv_len
# 40 leaves that warpgroup wholly masked.
TRAIN_SHAPE = ("train", 4, 4096, 8, 4, 128, True, None, "bfloat16")
EDGE_CASES = [
    ("S192_causal", 2, 192, 8, 4, 128, True, None, "bfloat16"),
    ("S64_one_tile", 2, 64, 8, 4, 128, True, None, "bfloat16"),
    ("kv_len77_D64", 2, 256, 8, 4, 64, False, 77, "bfloat16"),
    ("G8", 2, 256, 8, 1, 128, True, None, "bfloat16"),
    ("causal_kv_len100", 2, 256, 8, 4, 128, True, 100, "bfloat16"),
    ("kv_len40_D64", 2, 192, 8, 4, 64, False, 40, "bfloat16"),
]
FLASH_CASES = [
    ("slice", 8, 512, 8, 4, 128, True, None, "bfloat16"),
    TRAIN_SHAPE,
    ("unaligned_S500", 8, 500, 8, 4, 128, True, None, "bfloat16"),
    ("kv_len_noncausal", 4, 512, 8, 4, 128, False, 300, "bfloat16"),
    ("G1", 4, 256, 8, 8, 128, True, None, "bfloat16"),
    ("G2_D64", 4, 256, 8, 4, 64, True, None, "bfloat16"),
    ("f32_no_tf32", 2, 256, 8, 4, 128, True, None, "float32"),
    *EDGE_CASES,
]
# The forward is held by flash_attention.forward_agreement: o by relative L2
# error over the whole tensor, its late half and its worst row (GRAD_RTOL,
# ROW_RTOL below), since a late causal row's o is a few hundredths of the first
# rows'; o and lse also by their largest absolute error (FWD_ATOL: bf16 3e-2,
# f32 2e-5).
#
# The backward cases: the training shape first (timed; its numbers go into
# the kernels line), then padded S, non-causal kv_len, G 1, G 2 with D 64,
# f32 with TF32 off, and the tile-edge cases. Each gradient is held to its plain version by
# flash_attention.grad_agreement: relative L2 error over the whole tensor and
# over its late half within GRAD_RTOL (bf16 5e-3, f32 1e-4), and in its worst
# row within ROW_RTOL (bf16 3e-2, f32 3e-4), so that a fault confined to late
# tiles, whose causal gradients are 50-100x smaller than the first keys',
# shows.
BWD_CASES = [
    TRAIN_SHAPE,
    ("unaligned_S500", 2, 500, 8, 4, 128, True, None, "bfloat16"),
    ("kv_len_noncausal", 2, 512, 8, 4, 128, False, 300, "bfloat16"),
    ("G1", 2, 256, 8, 8, 128, True, None, "bfloat16"),
    ("G2_D64", 2, 256, 8, 4, 64, True, None, "bfloat16"),
    ("f32_no_tf32", 2, 256, 8, 4, 128, True, None, "float32"),
    *EDGE_CASES,
]
# The public function's bf16 gradients on the card against the plain forward
# and backward: the training shape (no padding) and a padded one (S 500,
# D 80), which exercises the autograd wrapper's pad of do and slice of the
# gradients.
AUTOGRAD_CASES = [TRAIN_SHAPE, ("padded_S500_D80", 2, 500, 8, 4, 80, True, None, "bfloat16")]


# One training step, flash + chunked loss against dense attention + dense
# loss on the same weights: both run bf16 matmuls in f32-accumulated products
# but round p (and the loss's f32 logits against the head's f32 product) at
# different points, which 16 layers carry into the loss and the gradients.
# Loss and global gradient norm (readings 3.7e-5 and 6.9e-5, NVIDIA H100 80GB
# HBM3 at 700 W) are held about 10x above their readings. The global norm is
# dominated by the embedding and LM head, so each layer's q/k/v projection
# gradient, which only a right attention backward gets right, is held as a
# relative L2 difference; dense rounds its bf16 dprobs before the softmax
# backward's subtraction, so these differ at the 1e-2 level.
TRAIN_LOSS_RTOL = 5e-4
TRAIN_GRAD_NORM_RTOL = 1e-3
TRAIN_QKV_GRAD_RTOL = 5e-2  # readings: median 1.3e-2, worst layer 2.0e-2
# Flash vs dense prefill, last-position logits: both run bf16 attention and
# differ in where they round (the kernel rounds unnormalized p to bf16 and
# divides after p·v; dense normalizes, then rounds), which 16 layers carry
# into the f32 logits.
LOGITS_TOL = 0.15


def _time_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` in ms: CUDA events around ``reps`` calls,
    enqueued behind a sleep kernel so that host overhead between launches
    does not leave the card idle inside the timed interval."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, reps: int = 50) -> float:
    """Host time of one ``fn()`` in µs: the wrapper, its tensor-map encodes
    and the launch, enqueued behind a sleep kernel so that no call waits on
    the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / reps


def _flash_bound_ms(B, S, H, KH, D, causal, kv_len, dtype) -> tuple:
    """Least time for one flash forward on this card: each input read once,
    each output written once, against the two matmuls over the (row, col)
    pairs that this case's mask keeps."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (2 * B * S * H * D + 2 * B * S * KH * D) + 4 * B * H * S
    ops = 4 * D * B * H * _causal_pairs(S, causal, kv_len)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _tflops(products: int, B, S, H, D, causal, kv_len, ms: float) -> float:
    """Achieved TFLOP/s of ``products`` matmuls over the live (row, col)
    pairs (2·D operations a pair each) in ``ms``."""
    return 2 * D * products * B * H * _causal_pairs(S, causal, kv_len) / (ms * 1e-3) / 1e12


def _causal_pairs(S, causal, kv_len) -> int:
    cols = kv_len or S
    return sum(min(r + 1, cols) for r in range(S)) if causal else S * cols


def _bwd_bound_ms(kernel, B, S, H, KH, D, causal, kv_len, dtype) -> tuple:
    """Least time for one backward kernel on this card: q, k, v, do, lse and
    delta read once and its gradients written once, against its products
    over the live (row, col) pairs — dq three (q·kᵀ, do·vᵀ, ds·k), dkv four
    (k·qᵀ, v·doᵀ, pᵀ·do, dsᵀ·q), 2·D operations a pair each."""
    esize = 2 if dtype == "bfloat16" else 4
    q_bytes, kv_bytes = esize * B * S * H * D, esize * B * S * KH * D
    rows = 4 * B * H * S  # one f32 row vector
    if kernel == "flash_bwd_dq":
        nbytes, products = 3 * q_bytes + 2 * kv_bytes + 2 * rows, 3
    else:
        nbytes, products = 2 * q_bytes + 4 * kv_bytes + 2 * rows, 4
    ops = 2 * D * products * B * H * _causal_pairs(S, causal, kv_len)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# The kernel a line of ptxas's report is about, from the mangled name of the
# entry it follows: (name, head width) of flash_bwd_dkv_sm90<128> and the like.
_PTXAS_KERNEL = re.compile(r"(?:entry function '|Function properties for )\w*(flash_\w+?)ILi(\d+)E")


def phase_identity_and_build():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        _fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    _log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from pytorch_operator_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build(["flash_fwd", "flash_bwd"])
    _log(f"built {sorted(paths)} in {time.perf_counter() - t0:.2f}s")
    serialised = []
    for name, report in _build.build_logs.items():
        kernel = name
        for line in report.splitlines():
            entry = _PTXAS_KERNEL.search(line)
            if entry:
                kernel = f"{entry.group(1)}<{entry.group(2)}>"
            if any(w in line for w in ("registers", "spill", "warning", "C7520", "Performance Loss")):
                _log(f"ptxas {kernel}: {line.strip()}")
            # ptxas's note that it serialised a kernel's wgmmas (one issued
            # under a condition): a silent slowdown of a kernel that is right.
            if "C7520" in line or "Performance Loss" in line:
                serialised.append(f"{kernel}: {line.strip()}")
    missing = sorted(set(paths) - set(_build.build_logs))
    _log(f"ptxas wgmma serialisation notes: {len(serialised)}"
         + (f" (libraries reused, not checked: {missing})" if missing else ""))
    if serialised:
        _fail(f"ptxas serialised wgmma: {serialised}")
    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    lib = fa._kernel_lib("flash_bwd")
    _log("flash_bwd_dkv_sm90 dynamic shared memory: "
         + ", ".join(f"D{d} {lib.flash_bwd_dkv_smem(d)} B" for d in fa.KERNEL_HEAD_DIMS))
    return card


def phase_flash_vs_plain():
    import torch
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    entry = None
    for name, B, S, H, KH, D, causal, kv_len, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (
            torch.randn((B, S, h, D), generator=gen, device="cuda", dtype=torch.float32).to(dt)
            for h in (H, KH, KH)
        )
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, kv_len=kv_len)
        torch.cuda.synchronize()
        # The plain version on the same (padded) inputs, on the card.
        _, _, S_pad, D_pad = fa._plan_tiling(S, D, 1024, 1024, True)
        pad = (0, D_pad - D, 0, 0, 0, S_pad - S)
        qp, kp, vp = (F.pad(x, pad) for x in (q, k, v))
        kv = kv_len or S
        scale = 1.0 / math.sqrt(D)
        o_ref, lse_ref = fa.flash_attention_reference(qp, kp, vp, causal=causal, kv_len=kv, scale=scale)
        o_ref, lse_ref = o_ref[:, :S, :, :D], lse_ref[:, :S]
        if not torch.isfinite(o.float()).all() or o.shape != (B, S, H, D):
            _fail(f"flash_fwd {name}: non-finite output or shape {tuple(o.shape)}")
        a = fa.forward_agreement(o, lse, o_ref, lse_ref, S)
        err = max(a["max_abs"], a["lse_max_abs"])
        _log(
            f"flash_fwd {name} {dtype}: o rel {a['rel']:.3e}, late half {a['rel_late']:.3e} "
            f"(tol {fa.GRAD_RTOL[o.dtype]:.0e}), worst row {a['rel_row']:.3e} (tol "
            f"{fa.ROW_RTOL[o.dtype]:.0e}); max_abs_err o {a['max_abs']:.3e}, lse "
            f"{a['lse_max_abs']:.3e} (tol {fa.FWD_ATOL[o.dtype]:.0e}) {'ok' if a['ok'] else 'FAIL'}"
        )
        if not a["ok"]:
            _fail(f"flash_fwd disagrees with its plain version in case {name}")
        if name in ("slice", "train"):
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            call = functools.partial(fa.flash_attention_with_lse, q, k, v, causal=causal, kv_len=kv_len)
            ms = _time_ms(call)
            host_us = _host_us(call)
            plain_ms = _time_ms(
                lambda: fa.flash_attention_reference(q, k, v, causal=causal, kv_len=kv, scale=scale),
                reps=5,
            )
            library_ms = _time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, enable_gqa=True)
            )
            bound_ms, bound_by = _flash_bound_ms(B, S, H, KH, D, causal, kv_len, dtype)
            _log(
                f"flash_fwd {name} timing: kernel {ms:.4f} ms "
                f"({_tflops(2, B, S, H, D, causal, kv_len, ms):.1f} TFLOP/s), plain "
                f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
                f"host {host_us:.1f} us a call"
            )
            shape = f"B{B} S{S} H{H} KH{KH} D{D} {'causal' if causal else 'full'} {dtype}"
            if name == "train":
                entry.update(
                    train_shape=shape, train_ms=ms, train_plain_ms=plain_ms,
                    train_bound_ms=bound_ms, train_bound_by=bound_by,
                    train_library_ms=library_ms, train_max_abs_err=err,
                )
                continue
            entry = {
                "name": "flash_fwd",
                "route": "cuda",
                "source": "pytorch_operator_tpu_torch/ops/csrc/flash_fwd.cu",
                "replaces": "pytorch_operator_tpu/ops/flash_attention.py:101",
                "max_abs_err": err,
                "ms": ms,
                "kernel_ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
                "shape": shape,
            }
    return [entry]


def _padded_case(gen, B, S, H, KH, D, dtype):
    """Random q, k, v, do for one case, padded as the wrapper pads them."""
    import torch
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, dtype)
    _, _, S_pad, D_pad = fa._plan_tiling(S, D, 1024, 1024, True)
    pad = (0, D_pad - D, 0, 0, 0, S_pad - S)
    return [
        F.pad(torch.randn((B, S, h, D), generator=gen, device="cuda").to(dt), pad)
        for h in (H, KH, KH, H)
    ]


def phase_backward_vs_plain():
    """Both backward kernels against their plain version on the same padded
    inputs (the forward kernel's o and lse), every case; times and bounds at
    the training shape."""
    import torch
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    entries = {}
    for name, B, S, H, KH, D, causal, kv_len, dtype in BWD_CASES:
        q, k, v, do = _padded_case(gen, B, S, H, KH, D, dtype)
        args = dict(causal=causal, kv_len=kv_len or S, scale=1.0 / math.sqrt(D))
        o, lse = fa._launch(q, k, v, **args)
        grads = fa._launch_bwd(q, k, v, o, lse, do, **args)
        torch.cuda.synchronize()
        refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do, **args)
        errs = {
            gname: _check_grad(f"flash_bwd {name} {dtype} {gname}", g, r, S)
            for gname, g, r in zip(("dq", "dk", "dv"), grads, refs)
        }
        del refs
        if name != "train":
            continue
        lse_c, delta = lse.contiguous(), fa.bwd_delta(o, do)
        kin = (q, k, v, do, lse_c, delta)
        dq_call = functools.partial(fa._launch_dq, *kin, **args)
        dq_ms, dq_host_us = _time_ms(dq_call), _host_us(dq_call)
        dkv_call = functools.partial(fa._launch_dkv, *kin, **args)
        dkv_ms, dkv_host_us = _time_ms(dkv_call), _host_us(dkv_call)
        plain_ms = _time_ms(
            lambda: fa.flash_attention_backward_reference(q, k, v, o, lse, do, **args), reps=3
        )
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, enable_gqa=True)
        doh = do.transpose(1, 2).contiguous()
        library_ms = _time_ms(
            lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True)
        )
        shape = f"B{B} S{S} H{H} KH{KH} D{D} {'causal' if causal else 'full'} {dtype}"
        for kname, ms, err in (
            ("flash_bwd_dq", dq_ms, errs["dq"]),
            ("flash_bwd_dkv", dkv_ms, max(errs["dk"], errs["dv"])),
        ):
            bound_ms, bound_by = _bwd_bound_ms(kname, B, S, H, KH, D, causal, kv_len, dtype)
            products = 3 if kname == "flash_bwd_dq" else 4
            _log(
                f"{kname} {name} timing: kernel {ms:.4f} ms "
                f"({_tflops(products, B, S, H, D, causal, kv_len, ms):.1f} TFLOP/s), plain "
                f"backward {plain_ms:.4f} ms, SDPA backward {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})"
            )
            entries[kname] = {
                "name": kname,
                "route": "cuda",
                "source": "pytorch_operator_tpu_torch/ops/csrc/flash_bwd.cu",
                "replaces": "pytorch_operator_tpu/ops/flash_attention.py:"
                + ("156" if kname == "flash_bwd_dq" else "197"),
                "max_abs_err": err,
                "ms": ms,
                "kernel_ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
                "shape": shape,
            }
        _log(
            f"backward {name}: dq + dkv {dq_ms + dkv_ms:.4f} ms (SDPA backward "
            f"{library_ms:.4f} ms); host a call: flash_bwd_dq {dq_host_us:.1f} us, "
            f"flash_bwd_dkv {dkv_host_us:.1f} us"
        )
        del out, qh, kh, vh
    torch.cuda.empty_cache()
    _autograd_vs_plain(gen)
    return [entries["flash_bwd_dq"], entries["flash_bwd_dkv"]]


def _check_grad(what: str, g, r, seq_len: int) -> float:
    """Hold one kernel gradient to its plain version (``grad_agreement``);
    log the readings, fail on disagreement, return the max abs error."""
    import torch

    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    if not torch.isfinite(g.float()).all() or g.shape != r.shape:
        _fail(f"{what}: non-finite or of shape {tuple(g.shape)}")
    a = fa.grad_agreement(g, r, seq_len)
    _log(
        f"{what}: rel {a['rel']:.3e}, late half {a['rel_late']:.3e} (tol "
        f"{fa.GRAD_RTOL[g.dtype]:.0e}), worst row {a['rel_row']:.3e} (tol "
        f"{fa.ROW_RTOL[g.dtype]:.0e}); max_abs_err {a['max_abs']:.3e} {'ok' if a['ok'] else 'FAIL'}"
    )
    if not a["ok"]:
        _fail(f"{what} disagrees with its plain version")
    return a["max_abs"]


def _autograd_vs_plain(gen):
    """bf16 gradients of ``flash_attention`` through autograd on the card
    (forward kernel, both backward kernels, the wrapper's padding) against
    the plain forward and backward on the same, unpadded inputs."""
    import torch

    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    for name, B, S, H, KH, D, causal, kv_len, dtype in AUTOGRAD_CASES:
        dt = getattr(torch, dtype)
        q, k, v, do = (
            torch.randn((B, S, h, D), generator=gen, device="cuda").to(dt) for h in (H, KH, KH, H)
        )
        qkv = [x.requires_grad_() for x in (q, k, v)]
        grads = torch.autograd.grad(fa.flash_attention(*qkv, causal=causal), qkv, do)
        q, k, v = (x.detach() for x in qkv)
        args = dict(causal=causal, kv_len=S, scale=1.0 / math.sqrt(D))
        o, lse = fa.flash_attention_reference(q, k, v, **args)
        refs = fa.flash_attention_backward_reference(q, k, v, o, lse, do, **args)
        for gname, g, r in zip(("dq", "dk", "dv"), grads, refs):
            _check_grad(f"autograd {name} {dtype} {gname}", g, r, S)
        del grads, refs, o, lse
    torch.cuda.empty_cache()


def _record_launches(kernels, path: str, launches: dict) -> None:
    for k in kernels:
        k.setdefault("launches_by_path", {})[path] = launches[k["name"]]


def phase_generate(kernels):
    import dataclasses

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import generate

    fa.reset_launch_count()
    result = generate.run(
        config="0.3b", batch_size=8, prompt_len=512, max_new_tokens=32,
        device="cuda", log=_log,
    )
    launches = fa.launch_counts()
    _log(f"generate path launches: {launches}")
    _record_launches(kernels, "generate", launches)
    n_layers = llama_lib.llama_0_3b().n_layers
    if result["flash_launches_per_generate"] != n_layers:
        _fail(
            f"flash kernel launched {result['flash_launches_per_generate']} times per "
            f"generate call, expected {n_layers} (one per layer)"
        )
    # run(): 1 + 3 timed generate calls and 3 timed prefills, each one prefill.
    if launches["flash_fwd"] != 7 * n_layers:
        _fail(f"flash kernel launched {launches['flash_fwd']} times, expected {7 * n_layers}")
    _log(
        f"generate 0.3b: {result['value']} tok/s, generate {result['generate_s']:.4f} s, "
        f"prefill_s {result['prefill_s']:.5f}"
    )

    # Flash vs dense attention on the same weights: last-position logits.
    cfg = llama_lib.llama_0_3b(decode=True, max_decode_len=512 + 32)
    flash_model, _ = generate.load_params(cfg, config="0.3b", device="cuda", seed=1, log=_log)
    dense_model = llama_lib.Llama(dataclasses.replace(cfg, attn_impl="dense"), device="meta")
    dense_model.load_state_dict(flash_model.state_dict(), assign=True)
    prompt = torch.randint(
        0, cfg.vocab_size, (8, 512), device="cuda", generator=torch.Generator("cuda").manual_seed(2)
    )
    logits = {}
    with torch.no_grad():
        for name, model in (("flash", flash_model), ("dense", dense_model)):
            cache = generate.init_cache(model, 8)
            hidden, _ = llama_lib.decode_forward(model, cache, prompt)
            logits[name] = hidden[:, -1].float() @ model.head_kernel()
    lf, ld = logits["flash"], logits["dense"]
    if lf.shape != (8, cfg.vocab_size) or not torch.isfinite(lf).all():
        _fail(f"flash prefill logits non-finite or of shape {tuple(lf.shape)}")
    err = (lf - ld).abs().max().item()
    agree = (lf.argmax(-1) == ld.argmax(-1)).float().mean().item()
    _log(
        f"prefill logits flash vs dense: max_abs_err {err:.4f} (tol {LOGITS_TOL}), "
        f"logit scale {ld.abs().max().item():.3f}, argmax agreement {agree:.3f}"
    )
    if err > LOGITS_TOL:
        _fail("flash and dense prefill logits disagree")
    return _profile_generate


def _profile_generate(new_tokens: int = 32):
    """Where one generate call's time goes: torch.profiler over one call
    (batch 8, 512-token prompt), device time by kernel and the card's busy
    share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import generate

    cfg = llama_lib.llama_0_3b(decode=True, max_decode_len=512 + new_tokens)
    model, _ = generate.load_params(cfg, config="0.3b", device="cuda", seed=1, log=_log)
    prompt = torch.randint(
        0, cfg.vocab_size, (8, 512), device="cuda", generator=torch.Generator("cuda").manual_seed(2)
    )
    gen = generate.make_generate(model, max_new_tokens=new_tokens)
    cache = generate.init_cache(model, prompt.shape[0])
    gen(cache, prompt, torch.Generator("cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen(cache, prompt, torch.Generator("cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_profile(prof, wall, f"one generate call ({new_tokens - 1} decode steps)")


def _report_profile(prof, wall: float, what: str, top: int = 12) -> tuple:
    """Device time by kernel from a torch.profiler run, the card's busy
    share of the wall time, and the number of kernel launches. Returns
    (busy seconds, launches)."""
    import torch

    rows = [
        (e.key, e.device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(t for _, t, _ in rows)
    launches = sum(n for _, _, n in rows)
    _log(
        f"profile of {what}: wall {1e3 * wall:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / 1e6 / wall:.1f}% of wall; profiler on), "
        f"{launches} kernel launches"
    )
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:top]:
        _log(f"  {t / 1e3:9.3f} ms  {n:6d}x  {key[:100]}")
    return busy_us / 1e6, launches


def phase_train(kernels):
    """The training main path at llama_0_3b, then flash + chunked against
    dense on the same weights. Returns the profile of one step, to run
    later."""
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import llama_train

    warmup, steps = 1, 5
    fa.reset_launch_count()
    result = llama_train.run(
        config="0.3b", batch_size=4, seq_len=4096, steps=steps, warmup=warmup,
        device="cuda", log=_log,
    )
    launches = fa.launch_counts()
    _log(f"training path launches: {launches}")
    _record_launches(kernels, "train", launches)
    n_layers = llama_lib.llama_0_3b().n_layers
    for name, n in launches.items():
        if n != n_layers * (warmup + steps):
            _fail(f"{name} launched {n} times on the training path, expected "
                  f"{n_layers * (warmup + steps)} (one per layer per step)")
    losses = result["losses"]
    if len(losses) != warmup + steps or not all(math.isfinite(x) for x in losses):
        _fail(f"training losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"training loss did not fall: {losses}")
    _log(
        f"train 0.3b (B4 x S4096): {result['value']} tokens/s, step {result['step_s']:.4f} s, "
        f"peak memory {result['peak_mem_bytes'] / 2**30:.2f} GiB, "
        f"losses {[round(x, 4) for x in losses]}, per step {result['flash_launches_per_step']}"
    )
    _train_parity()
    return _profile_train


def _train_model(cfg, seed: int):
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib

    model = llama_lib.Llama(cfg, device="cuda")
    return model.init_weights(torch.Generator(device="cuda").manual_seed(seed))


def _train_parity(B: int = 4, S: int = 1024):
    """One step's loss, global gradient norm and each layer's q/k/v
    projection gradients: flash attention + chunked loss against dense
    attention + dense loss, on the same weights."""
    import dataclasses

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import llama_train, trainer

    cfg = llama_lib.llama_0_3b()
    flash = _train_model(cfg, seed=3)
    toks = torch.from_numpy(llama_train.synthetic_bigram_batch(B, S, cfg.vocab_size, 0))
    toks = toks.to("cuda", torch.long)
    out = {}
    for name in ("flash", "dense"):
        if name == "flash":
            model = flash
        else:
            model = llama_lib.Llama(
                dataclasses.replace(cfg, attn_impl="dense", xent_impl="dense"), device="cuda"
            )
            model.load_state_dict(flash.state_dict())
            del flash
        loss = trainer.make_lm_loss_fn(model)(toks)
        loss.backward()
        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad) for p in model.parameters()])
        )
        qkv = {
            f"{i}.{proj}": getattr(layer.attn, proj).weight.grad
            for i, layer in enumerate(model.layers)
            for proj in ("q_proj", "k_proj", "v_proj")
        }
        out[name] = (float(loss.detach()), float(gnorm), qkv)
        del model, loss
    (lf, gf, qf), (ld, gd, qd) = out["flash"], out["dense"]
    dl, dg = abs(lf - ld) / abs(ld), abs(gf - gd) / gd
    dqkv = {
        key: (torch.linalg.vector_norm(qf[key] - qd[key]) / torch.linalg.vector_norm(qd[key])).item()
        for key in qd
    }
    worst = max(dqkv, key=dqkv.get)
    _log(
        f"train step flash+chunked vs dense (B{B} x S{S}): loss {lf:.5f} vs {ld:.5f} "
        f"(rel {dl:.2e}, tol {TRAIN_LOSS_RTOL:.0e}); grad norm {gf:.5f} vs {gd:.5f} "
        f"(rel {dg:.2e}, tol {TRAIN_GRAD_NORM_RTOL:.0e}); q/k/v projection gradients: "
        f"worst layer {worst} rel {dqkv[worst]:.2e}, median "
        f"{sorted(dqkv.values())[len(dqkv) // 2]:.2e} (tol {TRAIN_QKV_GRAD_RTOL:.0e})"
    )
    if (
        not (math.isfinite(lf) and math.isfinite(gf))
        or dl > TRAIN_LOSS_RTOL
        or dg > TRAIN_GRAD_NORM_RTOL
        or not dqkv[worst] <= TRAIN_QKV_GRAD_RTOL
    ):
        _fail("flash + chunked and dense training steps disagree")
    torch.cuda.empty_cache()


def _profile_train(B: int = 4, S: int = 4096):
    """Where one training step's time goes at the training shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.workloads import llama_train, trainer

    cfg = llama_lib.llama_0_3b()
    model = _train_model(cfg, seed=4)
    step = trainer.make_lm_train_step(model, trainer.make_optimizer(model.parameters(), 3e-4))
    toks = torch.from_numpy(llama_train.synthetic_bigram_batch(B, S, cfg.vocab_size, 0))
    toks = toks.to("cuda", torch.long)
    float(step(toks))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(toks))
        wall = time.perf_counter() - t0
    _report_profile(prof, wall, f"one training step (B{B} x S{S})", top=15)
    del model, step
    torch.cuda.empty_cache()


# The serve path's knobs: examples/serve.yaml's, without int8.
SERVE_KNOBS = dict(slots=8, chunk=128, block=64, max_decode_len=4096)
# Teacher forcing holds every greedy token the engine emits within LOGITS_TOL
# of its position's largest logit, and the exact argmax at no less than this
# share of a run's positions. The engine decodes at batch 8 and the dense
# model runs batch 1, so bf16 rounds apart, and random weights' logits lie
# close: a sound engine chose the exact argmax at 0.969 of the edge requests'
# positions, one whose admitted slot starts a position late at 0.882 (NVIDIA
# H100 80GB HBM3 at 700 W).
SERVE_EXACT_SHARE_MIN = 0.925


def _bench_stream(vocab: int):
    """The engine stream that bench.py times (bench.py:550-571): a warmup
    pair, then 24 requests of 64-511 prompt and 64-191 new tokens, their
    lengths drawn from the same seed-0 generator in the same order (the draws
    of bench.py's prompt tokens kept in step). Returns ``(warmup, stream)``,
    lists of ``(prompt_len, max_new_tokens)``."""
    import numpy as np

    rng = np.random.default_rng(0)
    warmup = [(100, 33), (260, 33)]
    for p, _ in warmup:
        rng.integers(0, vocab, (p,))
    stream = []
    for _ in range(24):
        p, n = int(rng.integers(64, 512)), int(rng.integers(64, 192))
        rng.integers(0, vocab, (p,))
        stream.append((p, n))
    return warmup, stream


def _pct(xs, q: float) -> float:
    """``ServingEngine.stats``'s percentile rule."""
    xs = sorted(xs)
    return round(xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))], 3)


def _teacher_gaps(model):
    """The dense non-decode model over ``model``'s tensors (no copy). Returns
    ``gaps(prompt, tokens)``: at each generated position, the largest logit
    less the emitted token's, on the host."""
    import dataclasses

    import numpy as np
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib

    teacher = llama_lib.Llama(
        dataclasses.replace(model.cfg, decode=False, attn_impl="dense"), device="meta"
    )
    teacher.load_state_dict(model.state_dict(), assign=True)
    head = teacher.head_kernel().float()

    @torch.no_grad()
    def gaps(prompt, toks):
        p, n = len(prompt), len(toks)
        seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
        hidden = teacher(torch.from_numpy(seq).long().cuda()[None], return_hidden=True)
        logits = hidden[0, p - 1 :].float() @ head  # [n, V]: position p-1+i predicts token i
        chosen = logits[torch.arange(n), torch.tensor(toks, device="cuda")]
        return (logits.max(-1).values - chosen).cpu()

    return gaps


def _hold_gaps(what: str, gaps: dict) -> None:
    """Fail unless every teacher-forced gap is within LOGITS_TOL and the
    exact argmax share reaches SERVE_EXACT_SHARE_MIN."""
    worst = max(gaps, key=lambda k: float(gaps[k].max()))
    exact = sum(int((g == 0).sum()) for g in gaps.values())
    total = sum(len(g) for g in gaps.values())
    _log(
        f"{what}: {len(gaps)} requests, {total} tokens teacher-forced; worst gap "
        f"{float(gaps[worst].max()):.4f} ({worst}; tol {LOGITS_TOL}); exact argmax share "
        f"{exact / total:.4f} (min {SERVE_EXACT_SHARE_MIN})"
    )
    if not float(gaps[worst].max()) <= LOGITS_TOL:
        _fail(f"{what}: an emitted token is not within LOGITS_TOL of its teacher-forced argmax")
    if not exact / total >= SERVE_EXACT_SHARE_MIN:
        _fail(f"{what}: the exact argmax share is below {SERVE_EXACT_SHARE_MIN}")


def phase_serve(kernels):
    """The serve main path at llama_0_3b through ``workloads.serve.run`` on
    bench.py's engine stream, every emitted token held by teacher forcing;
    then the engine on edge requests, held the same way; then a profile of
    one decode block."""
    import tempfile
    import threading
    import zlib

    import numpy as np
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.serving import Spool
    from pytorch_operator_tpu_torch.workloads import generate, serve

    cfg = llama_lib.llama_0_3b(decode=True, max_decode_len=SERVE_KNOBS["max_decode_len"])
    warmup, stream = _bench_stream(cfg.vocab_size)
    got, stream_ids, errors = {}, [], []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as spool_dir:
        spool = Spool(spool_dir)

        def client():
            # The warmup pair is answered before the stream is sent, so the
            # stats that serve.run resets after it hold the stream alone.
            try:
                for batch in (warmup, stream):
                    ids = [spool.submit(prompt_len=p, max_new_tokens=n) for p, n in batch]
                    if batch is stream:
                        stream_ids.extend(ids)
                    for rid, (p, n) in zip(ids, batch):
                        got[rid] = (p, n, spool.wait_response(rid, timeout=900))
            except Exception as e:  # reported below: the phase fails on it
                errors.append(repr(e))

        thread = threading.Thread(target=client, daemon=True)
        thread.start()
        fa.reset_launch_count()
        stats = serve.run(
            config="0.3b", spool_dir=spool_dir, **SERVE_KNOBS,
            max_requests=len(warmup) + len(stream), warmup=len(warmup), idle_timeout=300,
            seed=0, device="cuda", log=_log,
        )
        launches = fa.launch_counts()
        thread.join(timeout=120)
    _log(f"serve path launches: {launches}")
    _record_launches(kernels, "serve", launches)
    if errors or thread.is_alive():
        _fail(f"serve client failed: {errors or 'still waiting'}")
    n_all = len(warmup) + len(stream)
    if (stats["served"], stats["rejected"], len(got), stats["requests"]) != (n_all, 0, n_all, len(stream)):
        _fail(
            f"served {stats['served']}, rejected {stats['rejected']}, answered {len(got)}, "
            f"{stats['requests']} in the stats"
        )
    for rid, (p, n, r) in got.items():
        toks = r.get("tokens") or []
        if (
            len(toks) != n or r["prompt_len"] != p or not r["ttft_ms"] > 0
            or not all(0 <= t < cfg.vocab_size for t in toks)
        ):
            _fail(f"serve response {rid}: {len(toks)} tokens of {n}, prompt {r.get('prompt_len')}, "
                  f"ttft_ms {r.get('ttft_ms')}")
    if any(launches.values()):
        _fail("the serve path launched a flash kernel: the engine prefills through the cache")
    own = [got[rid][2]["ttft_ms"] - got[rid][2]["admit_wait_ms"] for rid in stream_ids]
    _log(
        f"serve 0.3b, bench.py's engine stream ({len(stream)} requests after a warmup pair, sent "
        f"at once into {SERVE_KNOBS['slots']} slots; prompts {min(p for p, _ in stream)}-"
        f"{max(p for p, _ in stream)}, new {min(n for _, n in stream)}-{max(n for _, n in stream)}, "
        f"{sum(n for _, n in stream)} tokens): decode {stats['decode_tokens_per_sec']} tok/s; "
        f"TTFT from submit (queueing behind the slots included) p50 {stats['ttft_ms_p50']} ms "
        f"p99 {stats['ttft_ms_p99']} ms; TTFT from admission (the request's own prefill and first "
        f"token) p50 {_pct(own, 0.5)} ms p99 {_pct(own, 0.99)} ms; TPOT p50 {stats['tpot_ms_p50']} "
        f"ms p99 {stats['tpot_ms_p99']} ms"
    )
    torch.cuda.empty_cache()
    # serve.run's weights (the same seed), and every stream token held against
    # the prompt serve.run synthesised for its id (crc32 of the id).
    model, _ = generate.load_params(cfg, config="0.3b", device="cuda", seed=0, log=_log, tag="serve")
    gaps = _teacher_gaps(model)
    held = {}
    for rid in stream_ids:
        p, _, r = got[rid]
        prompt = np.random.default_rng(zlib.crc32(rid.encode())).integers(0, cfg.vocab_size, (p,))
        held[rid] = gaps(prompt.astype(np.int32), r["tokens"])
    _hold_gaps("serve stream", held)
    engine = _serve_edges(model, gaps)
    _profile_decode_block(engine)
    return stats


def _serve_edges(model, gaps):
    """Edge requests through one engine on ``model``, every greedy token held
    by teacher forcing (``gaps``); a reading of agreement with the
    single-stream rollout."""
    import numpy as np
    import torch

    from pytorch_operator_tpu_torch.serving import Request, ServingEngine
    from pytorch_operator_tpu_torch.workloads import generate

    cfg, L, chunk = model.cfg, SERVE_KNOBS["max_decode_len"], SERVE_KNOBS["chunk"]
    engine = ServingEngine(cfg, model, slots=SERVE_KNOBS["slots"], chunk=chunk, block=SERVE_KNOBS["block"])
    rng = np.random.default_rng(11)
    shapes = [
        ("one_chunk", chunk, 96),
        ("second_chunk", chunk + 1, 96),
        ("budget_edge", L - 1 - 64, 64),  # p + new = L - 1
        ("single_token", 300, 1),
    ] + [(f"fill{i}", int(rng.integers(64, 1025)), int(rng.integers(16, 129))) for i in range(7)]
    prompts = {name: rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32) for name, p, _ in shapes}
    for name, _, n in shapes:
        engine.submit(Request(name, prompts[name], n, time.time()))
    results = {r.id: r for r in engine.run_until_drained()}
    if sorted(results) != sorted(name for name, _, _ in shapes):
        _fail(f"edge requests answered: {sorted(results)}")
    held, same = {}, 0
    for name, p, n in shapes:
        toks = results[name].tokens
        if len(toks) != n:
            _fail(f"edge request {name}: {len(toks)} tokens of {n}")
        held[name] = gaps(prompts[name], toks)
        with torch.no_grad():
            rollout, _ = generate.make_generate(model, max_new_tokens=n)(
                generate.init_cache(model, 1), torch.from_numpy(prompts[name]).long().cuda()[None],
                torch.Generator("cuda"),
            )
        same += int(rollout[0].tolist() == toks)
        g = held[name]
        _log(f"serve edge {name} (prompt {p}, new {n}): worst gap {float(g.max()):.4f}, "
             f"exact argmax {int((g == 0).sum())}/{n}, equals the rollout {rollout[0].tolist() == toks}")
    _log(f"serve edges: {len(shapes)} requests through {engine.slots} slots; requests equal to "
         f"the single-stream rollout {same}/{len(shapes)}")
    _hold_gaps("serve edges", held)
    torch.cuda.empty_cache()
    return engine


def _profile_decode_block(engine):
    """One decode block over all 8 slots: wall time with the profiler off,
    then the card's busy share and kernel launches per decode step with
    torch.profiler on, and the host ops that take the most host time, then
    one more block timed after the profiler session. The first iteration's
    wall less a block's is the admission of the 8 prompts (their prefill
    chunks and first tokens): the TTFT of a request that finds a free
    slot."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch.serving import Request

    prompt_len = 512
    rng = np.random.default_rng(13)
    for i in range(engine.slots):
        prompt = rng.integers(0, engine.cfg.vocab_size, (prompt_len,)).astype(np.int32)
        engine.submit(Request(f"prof{i}", prompt, 5 * engine.block, time.time()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step()  # admission and a first block
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.step()  # one block, no admission
    off = time.perf_counter() - t0
    chunks = engine.slots * -(-prompt_len // engine.chunk)
    _log(
        f"serve admission of {engine.slots} prompts of {prompt_len} ({chunks} prefill chunks of "
        f"{engine.chunk}): {1e3 * (first - off):.2f} ms (first iteration {1e3 * first:.2f} ms less "
        f"a block), {1e3 * (first - off) / chunks:.3f} ms a chunk"
    )
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        wall = time.perf_counter() - t0
    busy_s, launches = _report_profile(
        prof, wall, f"one decode block ({engine.block} steps x {engine.slots} slots)"
    )
    _log(
        f"serve decode block: {1e3 * off:.2f} ms with the profiler off "
        f"({1e3 * off / engine.block:.3f} ms a step); device busy {1e3 * busy_s / engine.block:.3f} "
        f"ms a step, {100 * busy_s / off:.1f}% of the unprofiled block; "
        f"{launches / engine.block:.1f} kernel launches a decode step"
    )
    host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    _log("host ops of the profiled block by self host time (profiler on):")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        _log(f"  host {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:80]}")
    t0 = time.perf_counter()
    engine.step()
    after = time.perf_counter() - t0
    _log(
        f"serve decode block after the profiler session: {1e3 * after:.2f} ms "
        f"({1e3 * after / engine.block:.3f} ms a step; before it {1e3 * off / engine.block:.3f})"
    )
    engine.abort_in_flight()


def main() -> int:
    card = phase_identity_and_build()
    kernels = phase_flash_vs_plain() + phase_backward_vs_plain()
    # Each path's profile runs after every timed run: no timed run follows
    # a profiler session.
    profiles = [phase_generate(kernels), phase_train(kernels)]
    phase_serve(kernels)
    for run_profile in profiles:
        run_profile()
    for k in kernels:
        k["launches"] = sum(k["launches_by_path"].values())
        if k["launches"] == 0:
            _fail(f"kernel {k['name']} never ran on a main path")

    import torch

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
