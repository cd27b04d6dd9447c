"""Llama causal-LM training on one GPU — the port of
``pytorch_operator_tpu/workloads/llama_train.py``.

The llama presets default to ``attn_impl="flash"`` and ``xent_impl="chunked"``,
so every step runs the flash forward kernel and both backward kernels once per
layer (ops/flash_attention.py) and the chunked-vocab loss (ops/chunked_xent.py),
with f32 master weights and bf16 compute, AdamW and an optional cosine schedule
(workloads/trainer.py), optionally with each block rematerialised
(``--remat``, ``--remat-policy``). Data is the JAX workload's synthetic
affine-bigram stream (token[t+1] = (5·token[t] + 3) mod V), or packed token
records (``--data-file``, ``--eval-file``) read by the native loader. With
``--checkpoint-every`` it saves into the supervisor-injected checkpoint
directory and resumes from it after a restart.

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
import math
import sys
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager, job_checkpoint_dir
from ..data import field_range, open_loader, read_meta
from ..models import llama as llama_lib
from ..models.convert import params_from_jax
from ..ops import flash_attention as flash_lib
from ..runtime import rendezvous
from ..runtime.device import device_name, resolve_device
from .trainer import (
    heartbeat_reporter,
    make_lm_eval_step,
    make_lm_train_step,
    make_optimizer,
    throughput_loop,
)


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
    data_file: str | None = None,
    eval_file: str | None = None,
    eval_batches: int = 8,
    checkpoint_every: int = 0,
    max_steps: int | None = None,
    remat: bool | None = None,
    remat_policy: str | None = None,
    donate: bool | None = None,
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
    included), ``peak_mem_bytes`` (the card's, None on the CPU),
    ``flash_launches_per_step`` and ``device``; with ``data_file`` also
    ``loader`` (``"native"`` or ``"python"``, the loader that ran), with
    ``donate`` given ``donate`` (a no-op here). Weights are a random init
    from ``seed`` (a ``torch.Generator``), or ``init_params``, a JAX param
    tree (nested dicts of arrays) loaded with ``params_from_jax`` in
    ``param_dtype``.

    Data: the synthetic bigram stream, or ``data_file``'s ``tokens``
    records (``data.pack --dataset text``) through the native loader, seed
    0; ``eval_file`` is validated before any training and its held-out loss
    (``eval_loss``, ``eval_perplexity``) reported after it, over at most
    ``eval_batches`` batches (seed 1). Every token id of both files is
    checked against the vocabulary first: on the card an id outside it is a
    device-side assert in the embedding, not XLA's silent clamp.

    With ``checkpoint_every`` and the supervisor's ``TPUJOB_CHECKPOINT_DIR``
    the run resumes from the newest verified checkpoint there (weights,
    AdamW moments and count, the data stream fast-forwarded), saves every
    ``checkpoint_every`` steps and at its end; ``max_steps`` is the global
    step budget across such lives."""
    dev = resolve_device(device)
    over = {}
    if remat is not None:
        over["remat"] = remat
    if remat_policy is not None:
        over["remat_policy"] = remat_policy
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
    if remat_policy not in (None, "full") and not cfg.remat:
        # Measuring the no-remat path while the caller believes the
        # selective policy is on would mislead ('full' without remat is
        # inert and allowed, as in JAX).
        raise ValueError(f"--remat-policy {remat_policy} has no effect without --remat")
    if grad_accum > 1 and batch_size % grad_accum:
        raise ValueError(f"--grad-accum {grad_accum} must divide the global batch {batch_size}")
    log(
        f"[llama] config={config} d_model={cfg.d_model} layers={cfg.n_layers} "
        f"attn={cfg.attn_impl} xent={cfg.xent_impl} remat={cfg.remat and cfg.remat_policy} "
        f"batch={batch_size} seq={seq_len} ({device_name(dev)})"
    )

    def open_token_file(path: str, flag: str, seed: int, do_open: bool = True):
        """Validate a packed token file (the whole-file vocabulary scan is
        a full read) and optionally open its loader."""
        meta = read_meta(path)
        names = [f.name for f in meta.fields]
        if "tokens" not in names:
            raise ValueError(
                f"{flag} needs a 'tokens' field; {path} has {names} "
                f"(pack with pytorch_operator_tpu_torch.data.pack --dataset text)"
            )
        f_tok = next(f for f in meta.fields if f.name == "tokens")
        if f_tok.shape[0] < seq_len:
            raise ValueError(f"{flag} records hold {f_tok.shape[0]} tokens < --seq-len {seq_len}")
        if f_tok.shape[0] > seq_len:
            log(
                f"[llama] WARNING: {flag} records hold {f_tok.shape[0]} tokens; only the "
                f"first {seq_len} of each are used (--seq-len) — repack with --seq-len "
                f"{seq_len} to use the whole corpus"
            )
        if meta.n_records < batch_size:
            raise ValueError(f"{flag} holds {meta.n_records} records < global batch {batch_size}")
        lo, hi = field_range(path, meta, "tokens")
        if int(lo) < 0 or int(hi) >= cfg.vocab_size:
            raise ValueError(
                f"{flag} token ids span [{int(lo)}, {int(hi)}] — outside the model vocab "
                f"[0, {cfg.vocab_size})"
            )
        if not do_open:
            return None, meta
        return open_loader(path, batch_size, seed=seed), meta

    def next_tokens(ldr):
        # A copy out of the loader's slot: the native loader recycles it at
        # the next next_batch(), and nothing here may outlive it.
        _, _, fields = ldr.next_batch()
        toks = np.array(fields["tokens"][:, :seq_len], np.int32, copy=True)
        return torch.from_numpy(toks).to(dev, torch.long)

    if eval_file:
        # Before any training compute: a bad eval file must not cost a
        # finished run its result.
        if eval_batches < 1:
            raise ValueError(f"eval_batches must be >= 1, got {eval_batches}")
        open_token_file(eval_file, "--eval-file", seed=1, do_open=False)

    t_init = time.time()
    model = llama_lib.Llama(cfg, device=dev)
    if init_params is not None:
        model.load_state_dict(params_from_jax(init_params, cfg))
    else:
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[llama] {n_params / 1e6:.1f}M params, init +{time.time() - t_init:.1f}s")

    # The cosine horizon defaults to --max-steps, the global budget across
    # resumed lives (the restored count is global), else this life's length.
    opt = make_optimizer(
        model.parameters(), lr, optimizer=optimizer, schedule=lr_schedule,
        warmup_steps=lr_warmup_steps,
        decay_steps=lr_decay_steps or max_steps or (steps + max(warmup, 1)),
        grad_clip=grad_clip, weight_decay=0.1,
    )
    train_step = make_lm_train_step(model, opt, grad_accum=grad_accum)

    def train_state():
        return {"params": model.state_dict(), "opt_state": opt.state_dict()}

    loader = None
    mgr = None
    start_step = 0
    # From here on, a failure (a corrupt checkpoint, a bad argument) must
    # not leak the native loader's prefetch thread and mapping.
    try:
        if data_file:
            loader, _ = open_token_file(data_file, "--data-file", seed=0)
            log(f"[llama] data {data_file}: {loader.kind} loader")

            def batches(step: int):
                return next_tokens(loader)

        else:

            def batches(step: int):
                toks = synthetic_bigram_batch(batch_size, seq_len, cfg.vocab_size, step)
                return torch.from_numpy(toks).to(dev, torch.long)

        ckpt_dir = job_checkpoint_dir()
        if checkpoint_every and ckpt_dir is not None:
            mgr = CheckpointManager(ckpt_dir)
            resumed = mgr.restore_or_none(train_state())
            if resumed is not None:
                start_step, restored = resumed
                model.load_state_dict(restored["params"])
                opt.load_state_dict(restored["opt_state"])
                del restored
                log(f"[llama] resumed from checkpoint at step {start_step}")
                if lr_schedule == "cosine" and not lr_decay_steps and not max_steps and start_step > 0:
                    log(
                        f"[llama] WARNING: resuming at step {start_step} with --lr-schedule "
                        "cosine but no --max-steps/--lr-decay-steps: the decay horizon "
                        f"defaulted to this life's {steps + max(warmup, 1)} steps, so the "
                        "resumed run trains at LR~0. Pass --max-steps (global budget) or "
                        "--lr-decay-steps."
                    )
                if loader is not None and start_step > 0:
                    # The same file and seed give the same order: skip what
                    # the previous life trained on.
                    for _ in range(start_step):
                        loader.next_batch()
                    log(f"[llama] data stream fast-forwarded {start_step} batches")
        if max_steps is not None:
            steps = max(min(steps, max_steps - start_step - max(warmup, 1)), 0)

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        counts = {}

        def on_first():
            rendezvous.report_first_step(start_step)
            counts["start"] = flash_lib.launch_counts()

        tokens_per_step = batch_size * seq_len
        losses, steps_per_sec, end_step = throughput_loop(
            train_step, batches, steps=steps, warmup=warmup, on_first_step=on_first,
            checkpoint_every=checkpoint_every,
            save=(lambda s: mgr.save(s, train_state())) if mgr is not None else None,
            start_step=start_step,
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
    finally:
        if loader is not None:
            loader.close()
    if mgr is not None:
        if mgr.latest_step() != end_step:
            mgr.save(end_step, train_state())
        mgr.close()
    steps_after_first = end_step - start_step - 1
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
    result = {
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
    if loader is not None:
        result["loader"] = loader.kind
    if donate is not None:
        result["donate"] = "no-op (torch has no buffer donation)"

    if eval_file:
        # Held-out loss: the training objective, a fixed batch order, no
        # updates.
        eval_loader, eval_meta = open_token_file(eval_file, "--eval-file", seed=1)
        try:
            eval_step = make_lm_eval_step(model)
            n_eval = max(1, min(eval_batches, eval_meta.n_records // batch_size))
            eval_losses = [float(eval_step(next_tokens(eval_loader))) for _ in range(n_eval)]
        finally:
            eval_loader.close()
        eval_loss = sum(eval_losses) / len(eval_losses)
        ppl = math.exp(min(eval_loss, 30.0))
        rendezvous.report_metrics(end_step, eval_loss=eval_loss, eval_perplexity=ppl)
        log(f"[llama] eval: loss {eval_loss:.4f} (ppl {ppl:.1f}) over {n_eval} held-out batch(es)")
        result["eval_loss"] = round(eval_loss, 4)
        result["eval_perplexity"] = round(ppl, 2)
    return result


# Flags of the JAX workload that this slice does not port, with the ROADMAP
# item each waits for. main() accepts them so that it can refuse them by name.
REFUSED_FLAGS = {
    "--mesh": "multi-GPU, ring/ulysses, MoE, pp",
    "--async-checkpoint": "the rest of slice 2's left-outs, async checkpoint",
    "--prefetch": "the rest of slice 2's left-outs, prefetch",
    "--experts": "multi-GPU, ring/ulysses, MoE, pp",
    "--moe-top-k": "multi-GPU, ring/ulysses, MoE, pp",
    "--moe-dispatch": "multi-GPU, ring/ulysses, MoE, pp",
    "--moe-capacity-factor": "multi-GPU, ring/ulysses, MoE, pp",
    "--moe-aux-weight": "multi-GPU, ring/ulysses, MoE, pp",
    "--pp-microbatches": "multi-GPU, ring/ulysses, MoE, pp",
    "--pp-schedule": "multi-GPU, ring/ulysses, MoE, pp",
    "--preempt-at": "the rest of slice 2's left-outs, preemption",
    "--preempt-index": "the rest of slice 2's left-outs, preemption",
    "--profile-dir": "the rest of slice 2's left-outs, profiling",
}
_BOOLEAN_REFUSED = {"--async-checkpoint"}


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
    p.add_argument(
        "--data-file", default=None,
        help="train from packed token records through the native loader "
        "(pack a text file byte-level with pytorch_operator_tpu_torch.data.pack "
        "--dataset text); default: the synthetic bigram stream",
    )
    p.add_argument(
        "--eval-file", default=None,
        help="held-out packed token file: report eval loss and perplexity "
        "after training (same objective, no updates)",
    )
    p.add_argument("--eval-batches", type=int, default=8, help="max held-out batches to average over")
    p.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="save every N steps into TPUJOB_CHECKPOINT_DIR and resume from it",
    )
    p.add_argument("--max-steps", type=int, default=None, help="global step budget across resumes")
    p.add_argument("--remat", action="store_true", help="recompute each block in the backward")
    p.add_argument(
        "--remat-policy", choices=("full", "dots"), default=None,
        help="with --remat: 'full' keeps only block inputs; 'dots' also keeps "
        "the projection/MLP GEMM outputs",
    )
    p.add_argument(
        "--donate", action=argparse.BooleanOptionalAction, default=None,
        help="accepted for the JAX workload's command lines; a no-op here "
        "(torch has no buffer donation: the step updates in place)",
    )
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
        data_file=args.data_file,
        eval_file=args.eval_file,
        eval_batches=args.eval_batches,
        checkpoint_every=args.checkpoint_every,
        max_steps=args.max_steps,
        remat=True if args.remat else None,
        remat_policy=args.remat_policy,
        donate=args.donate,
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
