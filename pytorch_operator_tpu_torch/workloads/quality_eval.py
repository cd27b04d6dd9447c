"""Quantization quality measured end to end through the serving path — the
port of ``pytorch_operator_tpu/workloads/quality_eval.py``.

- **Held-out loss through the serving path**: the teacher-forced next-token
  loss over held-out sequences computed by the decode stack itself,
  ``decode_forward`` with ``prefill_mode="cache"`` in chunks, so an int8-KV
  variant reads its quantized cache back as a serving request does (the
  training path's eval never touches a cache). Variants: the bf16 control
  (``fp``), int8 weights, and int8 weights with an int8 KV cache.
- **Next-token agreement against context fill**: a greedy fp rollout of
  ``drift_tokens`` from a held-out prompt, then each int8 variant
  teacher-forced over that same stream, its per-position argmax agreement
  whole, in the first window and in the last (independent rollouts would
  diverge at the first disagreement and measure nothing).

Run it on a trained checkpoint (the train -> checkpoint -> serve journey):

    python -m pytorch_operator_tpu_torch.workloads.quality_eval --config 0.3b \\
        --restore CKPT_DIR --eval-file eval.bin --eval-batches 2 --batch-size 8

It runs on ``cuda`` unless ``--device cpu`` or ``TPUJOB_PLATFORM=cpu`` asks
for the host; with neither and no GPU it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data import open_loader
from ..models import llama as llama_lib
from ..models.llama import decode_forward, init_decode_cache
from ..runtime.device import device_name, synchronize, world_device
from .generate import init_cache, load_params, make_generate


@torch.no_grad()
def eval_serving_stream(cfg, params, tokens, *, chunk: int = 128):
    """Teacher-forced pass of ``tokens`` ``[B, S]`` (int64, on the device
    the weights are on) through the serving decode stack, chunked cache-mode
    prefill. ``params`` is a serving model's state dict (bf16 matmul
    weights, or int8 weights and scales, as ``generate.load_params`` leaves
    them), shared without a copy. Returns ``(mean_nats, argmax [B, S-1])``:
    the held-out next-token loss and each position's greedy prediction, both
    with exactly the numerics a serving request sees."""
    B, S = tokens.shape
    if cfg.max_decode_len < S:
        raise ValueError(f"max_decode_len {cfg.max_decode_len} < sequence {S}")
    model = llama_lib.Llama(dataclasses.replace(cfg, prefill_mode="cache"), device="meta")
    model.load_state_dict(params, assign=True)
    model.eval()
    cache = init_decode_cache(model.cfg, B, device=tokens.device)
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    count = 0
    preds = []
    for start in range(0, S, chunk):
        size = min(chunk, S - start)
        positions = torch.arange(start, start + size, device=tokens.device).expand(B, size)
        logits, cache = decode_forward(
            model, cache, tokens[:, start : start + size], positions, return_hidden=False
        )
        # logits[:, j] predicts token start + j + 1.
        targets = tokens[:, start + 1 : start + size + 1]
        t = targets.shape[1]  # == size except at the end of the sequence
        if t:
            total += F.cross_entropy(
                logits[:, :t].float().reshape(B * t, -1), targets.reshape(-1), reduction="sum"
            )
            count += B * t
        preds.append(logits.argmax(-1))
    return float(total) / count, torch.cat(preds, dim=1)[:, : S - 1].cpu().numpy()


def run(
    *,
    config: str = "tiny",
    n_layers: int | None = None,
    restore: str,
    eval_file: str,
    eval_batches: int = 2,
    batch_size: int = 8,
    seq_len: int | None = None,
    chunk: int = 128,
    drift_tokens: int = 2048,
    drift_window: int = 256,
    drift_prompt: int = 128,
    seed: int = 0,
    device=None,
    log=print,
) -> dict:
    """fp / int8 / int8 + kv8 held-out loss through the serving path, and
    agreement drift over a ``drift_tokens`` greedy fp rollout. The result
    keys are the JAX workload's, with ``device`` and ``drift_rollout_s``
    (the rollout's wall time) beside them."""
    dev = world_device(device)
    # Held-out sequences from the packed eval file (the format the trainer's
    # --eval-file takes).
    loader = open_loader(eval_file, batch_size, seed=1)
    batches = []
    try:
        for _ in range(eval_batches):
            _, _, fields = loader.next_batch()
            # A copy out of the borrowed slot: the native loader recycles it
            # at the next next_batch()/close(), and a held view then reads
            # another batch's bytes.
            batches.append(np.array(fields["tokens"], np.int32, copy=True))
    finally:
        loader.close()
    eval_tokens = np.concatenate(batches, axis=0)
    if seq_len:
        eval_tokens = eval_tokens[:, :seq_len]
    S = eval_tokens.shape[1]
    L = max(S, drift_prompt + drift_tokens)

    cfg_q = getattr(llama_lib, llama_lib.CONFIGS[config])(
        decode=True, max_decode_len=L, quantize="int8",
        **({} if n_layers is None else {"n_layers": n_layers}),
    )
    # One restore, one set of f32 weights: the bf16 control cast from them
    # and the int8 model quantized from them, as JAX's quantize_tree of the
    # restored tree.
    model_q, n_params, model_fp, restored_step = load_params(
        cfg_q, config=config, device=dev, restore=restore, quantize="int8",
        compare_unquantized=True, seed=seed, log=log, tag="quality",
    )
    variants = {
        "fp": (model_fp.cfg, model_fp.state_dict()),
        "int8": (cfg_q, model_q.state_dict()),
        "int8_kv8": (dataclasses.replace(cfg_q, kv_quantize="int8"), model_q.state_dict()),
    }
    out = {
        "config": config,
        "restored_step": restored_step,
        "params_m": round(n_params / 1e6, 1),
        "eval_rows": int(eval_tokens.shape[0]),
        "eval_seq_len": int(S),
        "device": device_name(dev),
    }
    toks_dev = torch.from_numpy(eval_tokens).to(dev, torch.long)
    preds = {}
    for name, (cfg_v, p_v) in variants.items():
        loss, pred = eval_serving_stream(cfg_v, p_v, toks_dev, chunk=chunk)
        preds[name] = pred
        out[f"{name}_eval_loss"] = round(loss, 4)
        log(f"[quality] {name}: held-out loss {loss:.4f} (serving path)")
    out["int8_loss_delta"] = round(out["int8_eval_loss"] - out["fp_eval_loss"], 4)
    out["int8_kv8_loss_delta"] = round(out["int8_kv8_eval_loss"] - out["fp_eval_loss"], 4)
    # Argmax agreement with the fp serving path on the same held-out
    # context, position for position.
    for name in ("int8", "int8_kv8"):
        out[f"{name}_eval_argmax_agreement"] = round(float((preds[name] == preds["fp"]).mean()), 4)

    # Drift against context fill: a greedy fp rollout, each variant
    # teacher-forced over the same stream, agreement by window.
    rng = np.random.default_rng(seed + 1)
    row = int(rng.integers(0, eval_tokens.shape[0]))
    prompt = eval_tokens[row : row + 1, :drift_prompt]
    gen = make_generate(model_fp, max_new_tokens=drift_tokens)
    t0 = time.perf_counter()
    rollout, _ = gen(
        init_cache(model_fp, 1), torch.from_numpy(prompt).to(dev, torch.long),
        torch.Generator(device=dev).manual_seed(seed),
    )
    synchronize(dev)
    out["drift_rollout_s"] = round(time.perf_counter() - t0, 3)
    log(f"[quality] greedy fp rollout of {drift_tokens} tokens at batch 1: {out['drift_rollout_s']} s")
    stream = np.concatenate([prompt, rollout.cpu().numpy().astype(np.int32)], axis=1)
    stream_dev = torch.from_numpy(stream).to(dev, torch.long)
    drift = {}
    for name in ("int8", "int8_kv8"):
        cfg_v, p_v = variants[name]
        _, pred = eval_serving_stream(cfg_v, p_v, stream_dev, chunk=chunk)
        # Token i of the stream (i >= drift_prompt) is predicted at position
        # i - 1: the whole tail of pred from drift_prompt - 1 on.
        agree = pred[0, drift_prompt - 1 :] == stream[0, drift_prompt:]
        n = agree.shape[0]
        w = min(drift_window, n // 2)
        drift[name] = {
            "overall": round(float(agree.mean()), 4),
            "first": round(float(agree[:w].mean()), 4),
            "last": round(float(agree[-w:].mean()), 4),
            "window": int(w),
            "tokens": int(n),
        }
        log(f"[quality] {name} drift: {drift[name]}")
    out["drift"] = drift
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", choices=sorted(llama_lib.CONFIGS), default="tiny")
    p.add_argument(
        "--layers", type=int, default=None, dest="n_layers",
        help="the preset's depth cut to this many layers (as llama_train --layers; "
        "a checkpoint must have been trained at the same depth)",
    )
    p.add_argument("--restore", required=True, metavar="CKPT_DIR")
    p.add_argument("--eval-file", required=True)
    p.add_argument("--eval-batches", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--drift-tokens", type=int, default=2048)
    p.add_argument("--drift-window", type=int, default=256)
    p.add_argument("--drift-prompt", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; TPUJOB_PLATFORM=cpu also selects the CPU",
    )
    args = p.parse_args(argv)
    result = run(
        config=args.config,
        n_layers=args.n_layers,
        restore=args.restore,
        eval_file=args.eval_file,
        eval_batches=args.eval_batches,
        batch_size=args.batch_size,
        seq_len=args.seq_len,
        chunk=args.chunk,
        drift_tokens=args.drift_tokens,
        drift_window=args.drift_window,
        drift_prompt=args.drift_prompt,
        seed=args.seed,
        device=args.device,
        log=lambda m: print(m, flush=True),
    )
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
