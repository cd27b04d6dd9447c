"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. Card identity (``nvidia-smi`` name and power limit), then the build of
   every kernel source with nvcc (all at once), with its time and ptxas's
   register report.
2. Each kernel against its plain PyTorch version on the card, in the listed
   cases, with the stated tolerance; kernel, plain-version and library
   (``scaled_dot_product_attention``, timed only) times at the shape the main
   path gives the kernel.
3. The main path through the port's entry point: ``workloads.generate.run``
   at ``llama_0_3b`` full width and depth (batch 8, 512-token prompt, 32 new
   tokens, random weights from a seed). Launch counts are set to 0 just
   before and read just after; every kernel must have run, the flash kernel
   once per layer per prefill. Then the prefill's last-position logits of the
   flash model are held against the dense-attention model on the same
   weights.
4. One ``{"kernels": [...]}`` line, the card's line, and as the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
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
# first — its numbers go into the kernels line.
FLASH_CASES = [
    ("slice", 8, 512, 8, 4, 128, True, None, "bfloat16"),
    ("unaligned_S500", 8, 500, 8, 4, 128, True, None, "bfloat16"),
    ("kv_len_noncausal", 4, 512, 8, 4, 128, False, 300, "bfloat16"),
    ("G1", 4, 256, 8, 8, 128, True, None, "bfloat16"),
    ("G2_D64", 4, 256, 8, 4, 64, True, None, "bfloat16"),
    ("f32_no_tf32", 2, 256, 8, 4, 128, True, None, "float32"),
]
TOL = {"bfloat16": 3e-2, "float32": 2e-5}
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


def _flash_bound_ms(B, S, H, KH, D, causal, kv_len, dtype) -> tuple:
    """Least time for one flash forward on this card: each input read once,
    each output written once, against the two matmuls over the (row, col)
    pairs that this case's mask keeps."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * (2 * B * S * H * D + 2 * B * S * KH * D) + 4 * B * H * S
    cols = kv_len or S
    if causal:
        pairs = sum(min(r + 1, cols) for r in range(S))
    else:
        pairs = S * cols
    ops = 4 * D * B * H * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    paths = _build.build(["flash_fwd"])
    _log(f"built {sorted(paths)} in {time.perf_counter() - t0:.2f}s")
    for name, report in _build.build_logs.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                _log(f"ptxas {name}: {line.strip()}")
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
        err = max(
            (o.float() - o_ref.float()).abs().max().item(),
            (lse - lse_ref).abs().max().item(),
        )
        ok = err <= TOL[dtype]
        _log(f"flash_fwd {name} {dtype}: max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            _fail(f"flash_fwd disagrees with its plain version in case {name}")
        if entry is None:
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            ms = _time_ms(lambda: fa.flash_attention_with_lse(q, k, v, causal=causal, kv_len=kv_len))
            plain_ms = _time_ms(
                lambda: fa.flash_attention_reference(q, k, v, causal=causal, kv_len=kv, scale=scale),
                reps=5,
            )
            library_ms = _time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, enable_gqa=True)
            )
            bound_ms, bound_by = _flash_bound_ms(B, S, H, KH, D, causal, kv_len, dtype)
            _log(
                f"flash_fwd {name} timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
            )
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
                "shape": f"B{B} S{S} H{H} KH{KH} D{D} {'causal' if causal else 'full'} {dtype}",
            }
    return [entry]


def phase_main_path(kernels):
    import dataclasses

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.ops import flash_attention as fa
    from pytorch_operator_tpu_torch.workloads import generate

    counters = {"flash_fwd": fa}
    for mod in counters.values():
        mod.reset_launch_count()
    result = generate.run(
        config="0.3b", batch_size=8, prompt_len=512, max_new_tokens=32,
        device="cuda", log=_log,
    )
    launches = {name: mod.launch_count for name, mod in counters.items()}
    _log(f"main path launches: {launches}")
    n_layers = llama_lib.llama_0_3b().n_layers
    if result["flash_launches_per_generate"] != n_layers:
        _fail(
            f"flash kernel launched {result['flash_launches_per_generate']} times per "
            f"generate call, expected {n_layers} (one per layer)"
        )
    # run(): 1 + 3 timed generate calls and 3 timed prefills, each one prefill.
    if launches["flash_fwd"] != 7 * n_layers:
        _fail(f"flash kernel launched {launches['flash_fwd']} times, expected {7 * n_layers}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            _fail(f"kernel {k['name']} never ran on the main path")
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
    _profile_generate(flash_model, prompt)
    return result


def _profile_generate(model, prompt, new_tokens: int = 32):
    """Where one generate call's time goes: torch.profiler over one call,
    device time by kernel and the card's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_operator_tpu_torch.workloads import generate

    gen = generate.make_generate(model, max_new_tokens=new_tokens)
    cache = generate.init_cache(model, prompt.shape[0])
    gen(cache, prompt, torch.Generator("cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen(cache, prompt, torch.Generator("cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [
        (e.key, e.device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(t for _, t, _ in rows)
    _log(
        f"profile of one generate call: wall {1e3 * wall:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / 1e6 / wall:.1f}% of wall; profiler on)"
    )
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:12]:
        _log(f"  {t / 1e3:9.3f} ms  {n:6d}x  {key[:100]}")


def main() -> int:
    card = phase_identity_and_build()
    kernels = phase_flash_vs_plain()
    phase_main_path(kernels)

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
