"""Llama causal-LM training on one GPU — the port of
``pytorch_operator_tpu/workloads/llama_train.py``.

The llama presets default to ``attn_impl="flash"`` and ``xent_impl="chunked"``,
so every step runs the flash forward kernel and both backward kernels once per
layer (ops/flash_attention.py) and the chunked-vocab loss (ops/chunked_xent.py),
with f32 master weights and bf16 compute, AdamW and an optional cosine schedule
(workloads/trainer.py). Data is the JAX workload's synthetic affine-bigram
stream (token[t+1] = (5·token[t] + 3) mod V): falling loss proves learning,
and the input pipeline costs nothing.

    python -m pytorch_operator_tpu_torch.workloads.llama_train --config 0.3b \\
        --batch-size 4 --seq-len 4096 --steps 5 --json

It runs on ``cuda`` unless ``--device cpu`` or ``TPUJOB_PLATFORM=cpu`` asks
for the host; with neither and no GPU it raises. Flags of the JAX workload
that this slice does not port are refused with the ROADMAP item they wait
for (:data:`REFUSED_FLAGS`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models import llama as llama_lib
from ..models.convert import params_from_jax
from ..ops import flash_attention as flash_lib
from ..runtime import rendezvous
from ..runtime.device import device_name, resolve_device
from .trainer import heartbeat_reporter, make_lm_train_step, make_optimizer, throughput_loop


def synthetic_bigram_batch(batch: int, seq_len: int, vocab: int, step: int):
    """Deterministic learnable stream: next = (5·tok + 3) mod vocab."""
    rng = np.random.default_rng(step)
    first = rng.integers(0, vocab, size=(batch, 1), dtype=np.int64)
    toks = [first]
    for _ in range(seq_len - 1):
        toks.append((toks[-1] * 5 + 3) % vocab)
    return np.concatenate(toks, axis=1).astype(np.int32)


CONFIGS = llama_lib.CONFIGS

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def run(
    *,
    config: str = "tiny",
    batch_size: int = 8,
    seq_len: int = 128,
    steps: int = 20,
    warmup: int = 2,
    lr: float = 3e-4,
    optimizer: str = "adamw",
    lr_schedule: str = "constant",
    lr_warmup_steps: int = 0,
    lr_decay_steps: int | None = None,
    grad_clip: float | None = None,
    grad_accum: int = 1,
    n_layers: int | None = None,
    param_dtype: str | None = None,
    attn_impl: str | None = None,
    xent_impl: str | None = None,
    device=None,
    seed: int = 0,
    init_params=None,
    log=print,
) -> dict:
    """Train ``config`` for ``warmup`` + ``steps`` steps and return the JAX
    workload's result keys plus ``step_s``, ``losses`` (every step, warmup
    included), ``peak_mem_bytes`` (the card's, None on the CPU) and
    ``flash_launches_per_step``. Weights are a random init from ``seed``
    (a ``torch.Generator``), or ``init_params``, a JAX param tree (nested
    dicts of arrays) loaded with ``params_from_jax`` in ``param_dtype``."""
    dev = resolve_device(device)
    over = {}
    if n_layers is not None:
        over["n_layers"] = n_layers
    if attn_impl is not None:
        over["attn_impl"] = attn_impl
    if xent_impl is not None:
        over["xent_impl"] = xent_impl
    if param_dtype is not None:
        if param_dtype not in _DTYPES:
            raise ValueError(f"param_dtype={param_dtype!r} not in {sorted(_DTYPES)}")
        over["param_dtype"] = _DTYPES[param_dtype]
    cfg = getattr(llama_lib, CONFIGS[config])(**over)
    if grad_accum > 1 and batch_size % grad_accum:
        raise ValueError(f"--grad-accum {grad_accum} must divide the global batch {batch_size}")
    log(
        f"[llama] config={config} d_model={cfg.d_model} layers={cfg.n_layers} "
        f"attn={cfg.attn_impl} xent={cfg.xent_impl} batch={batch_size} seq={seq_len} "
        f"({device_name(dev)})"
    )

    t_init = time.time()
    model = llama_lib.Llama(cfg, device=dev)
    if init_params is not None:
        model.load_state_dict(params_from_jax(init_params, cfg))
    else:
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[llama] {n_params / 1e6:.1f}M params, init +{time.time() - t_init:.1f}s")

    opt = make_optimizer(
        model.parameters(), lr, optimizer=optimizer, schedule=lr_schedule,
        warmup_steps=lr_warmup_steps,
        decay_steps=lr_decay_steps or (steps + max(warmup, 1)),
        grad_clip=grad_clip, weight_decay=0.1,
    )
    train_step = make_lm_train_step(model, opt, grad_accum=grad_accum)

    def batches(step: int):
        toks = synthetic_bigram_batch(batch_size, seq_len, cfg.vocab_size, step)
        return torch.from_numpy(toks).to(dev, torch.long)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    counts = {}

    def on_first():
        rendezvous.report_first_step(0)
        counts["start"] = flash_lib.launch_counts()

    tokens_per_step = batch_size * seq_len
    losses, steps_per_sec, end_step = throughput_loop(
        train_step, batches, steps=steps, warmup=warmup, on_first_step=on_first,
        log=lambda m: log(f"[llama] {m}"),
        progress=(
            heartbeat_reporter(
                rendezvous.report_progress, batch=tokens_per_step, unit="tokens/sec/chip"
            )
            if rendezvous.progress_enabled()
            else None
        ),
    )
    done = flash_lib.launch_counts()
    steps_after_first = end_step - 1
    per_step = {
        k: (done[k] - counts["start"][k]) // max(steps_after_first, 1) for k in done
    }
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    losses = [float(x) for x in losses]
    final_loss = losses[-1]
    tokens_per_sec = steps_per_sec * tokens_per_step
    rendezvous.report_metrics(
        end_step, tokens_per_sec=tokens_per_sec, tokens_per_sec_per_chip=tokens_per_sec,
        final_loss=final_loss,
    )
    log(
        f"[llama] {steps} steps: {tokens_per_sec:,.0f} tokens/sec "
        f"({1000 / steps_per_sec if steps_per_sec else float('nan'):.1f} ms/step), "
        f"final loss {final_loss:.3f}"
        + (f", peak memory {peak / 2**30:.2f} GiB" if peak is not None else "")
    )
    return {
        "metric": "llama_train_tokens_per_sec_per_chip",
        "value": round(tokens_per_sec, 1),
        "unit": "tokens/sec/chip",
        "config": config,
        "params_m": round(n_params / 1e6, 1),
        "final_loss": round(final_loss, 4),
        "end_step": end_step,
        "devices": 1,
        "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "step_s": 1.0 / steps_per_sec if steps_per_sec else None,
        "losses": losses,
        "peak_mem_bytes": peak,
        "flash_launches_per_step": per_step,
        "device": device_name(dev),
    }


# Flags of the JAX workload that this slice does not port, with the ROADMAP
# item each waits for. main() accepts them so that it can refuse them by name.
REFUSED_FLAGS = {
    "--mesh": "multi-GPU, ring/ulysses, MoE, pp",
    "--data-file": "data and eval files",
    "--eval-file": "data and eval files",
    "--eval-batches": "data and eval files",
    "--checkpoint-every": "checkpointing",
    "--async-checkpoint": "checkpointing",
    "--max-steps": "checkpointing",
    "--prefetch": "prefetch",
    "--remat": "remat",
    "--remat-policy": "remat",
    "--experts": "multi-GPU, ring/ulysses, MoE, pp",
    "--moe-top-k": "multi-GPU, ring/ulysses, MoE, pp",
    "--moe-dispatch": "multi-GPU, ring/ulysses, MoE, pp",
    "--moe-capacity-factor": "multi-GPU, ring/ulysses, MoE, pp",
    "--moe-aux-weight": "multi-GPU, ring/ulysses, MoE, pp",
    "--pp-microbatches": "multi-GPU, ring/ulysses, MoE, pp",
    "--pp-schedule": "multi-GPU, ring/ulysses, MoE, pp",
    "--preempt-at": "preemption flags",
    "--preempt-index": "preemption flags",
    "--profile-dir": "profiling",
}
_BOOLEAN_REFUSED = {"--async-checkpoint", "--remat"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", choices=sorted(CONFIGS), default="tiny")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument(
        "--lr-schedule", choices=("constant", "cosine"), default="constant",
        help="cosine = linear warmup to --lr then cosine decay over "
        "--lr-decay-steps (default: the run length)",
    )
    p.add_argument("--lr-warmup-steps", type=int, default=0)
    p.add_argument("--lr-decay-steps", type=int, default=None)
    p.add_argument(
        "--grad-clip", type=float, default=None,
        help="clip gradients to this global norm (standard LM recipe: 1.0)",
    )
    p.add_argument(
        "--optimizer", choices=("adamw", "adafactor"), default="adamw",
        help="adafactor is not ported yet and is refused",
    )
    p.add_argument(
        "--grad-accum", type=int, default=1,
        help="split the batch into N sequential microbatches (gradients "
        "summed in f32, one optimizer update)",
    )
    p.add_argument(
        "--attn-impl", choices=("dense", "flash", "ring", "ulysses"), default=None,
        help="attention implementation (flash = the CUDA kernels); ring and "
        "ulysses are refused",
    )
    p.add_argument("--xent", choices=("dense", "chunked"), default=None, dest="xent_impl")
    p.add_argument("--layers", type=int, default=None, dest="n_layers")
    p.add_argument(
        "--param-dtype", choices=tuple(_DTYPES), default=None, dest="param_dtype",
        help="parameter storage dtype (default float32)",
    )
    p.add_argument("--seed", type=int, default=0, help="seed of the random init")
    p.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; TPUJOB_PLATFORM=cpu also selects the CPU",
    )
    p.add_argument("--json", action="store_true")
    refused = p.add_argument_group("not ported yet (refused)")
    for flag in REFUSED_FLAGS:
        if flag in _BOOLEAN_REFUSED:
            refused.add_argument(flag, action="store_true")
        else:
            refused.add_argument(flag, default=None)
    args = p.parse_args(argv)
    for flag, item in REFUSED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md: {item})"
            )

    world = rendezvous.initialize_from_env()
    result = run(
        config=args.config,
        batch_size=args.batch_size,
        seq_len=args.seq_len,
        steps=args.steps,
        warmup=args.warmup,
        lr=args.lr,
        optimizer=args.optimizer,
        lr_schedule=args.lr_schedule,
        lr_warmup_steps=args.lr_warmup_steps,
        lr_decay_steps=args.lr_decay_steps,
        grad_clip=args.grad_clip,
        grad_accum=args.grad_accum,
        n_layers=args.n_layers,
        param_dtype=args.param_dtype,
        attn_impl=args.attn_impl,
        xent_impl=args.xent_impl,
        device=args.device,
        seed=args.seed,
        log=lambda msg: print(msg, flush=True),
    )
    if args.json and world.process_id == 0:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
