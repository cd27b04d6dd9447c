"""Autoregressive generation with a KV cache — the port of
``pytorch_operator_tpu/workloads/generate.py``.

Prefill writes the whole prompt into the cache in one forward (causal
self-attention over the prompt: the flash kernel under the llama configs'
``attn_impl="flash"`` default, one launch per layer), then a Python loop of
single-token decode steps attends against the cache, which every step updates
in place. Sampling runs on the device from an explicit ``torch.Generator``.

No tokenizer ships here (no network), so the CLI drives synthetic prompts:

    python -m pytorch_operator_tpu_torch.workloads.generate --config 0.3b \
        --batch-size 8 --prompt-len 512 --max-new-tokens 32 --json

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

from ..checkpoint import CheckpointManager
from ..models import llama as llama_lib
from ..models.convert import is_quantized_tree, params_from_jax
from ..ops import flash_attention as flash_lib
from ..ops import quantize as quant_lib
from ..ops.sampling import make_sampler
from ..runtime import rendezvous
from ..parallel.collectives import world as joined_world
from ..runtime.device import device_name, synchronize, world_device


def make_generate(
    model,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
):
    """Build ``generate(cache, prompt, generator) -> (tokens [B,
    max_new_tokens], cache)``. ``model`` must be built with
    ``cfg.decode=True``; greedy when ``temperature == 0``.

    CONTRACT (``decode_per_row=False``): every prompt row occupies the same
    positions — an unpadded, equal-length prompt batch (cache writes use row
    0's offsets).
    """
    from ..models.llama import decode_forward

    sample = make_sampler(temperature, top_k, top_p)

    def last_logits(hidden):
        # Head matmul on the LAST position only: prefill would otherwise
        # materialize [B, prompt_len, vocab] f32 logits to sample one token.
        return hidden[:, -1].float() @ model.head_kernel()

    @torch.no_grad()
    def generate(cache, prompt, generator):
        B, Sp = prompt.shape
        L = model.cfg.max_decode_len
        if Sp + max_new_tokens > L:
            # An index past the cache would fault mid-rollout; fail first.
            raise ValueError(
                f"prompt_len {Sp} + max_new_tokens {max_new_tokens} "
                f"exceeds cfg.max_decode_len {L}"
            )
        hidden, cache = decode_forward(model, cache, prompt)
        tok = sample(last_logits(hidden), generator)
        out = [tok]
        for i in range(max_new_tokens - 1):
            positions = torch.full((B, 1), Sp + i, dtype=torch.long, device=prompt.device)
            hidden, cache = decode_forward(model, cache, tok[:, None], positions)
            tok = sample(last_logits(hidden), generator)
            out.append(tok)
        return torch.stack(out, dim=1), cache

    return generate


def init_cache(model, batch: int, prompt_len: int = 0):
    """Zero KV cache for ``model`` (cfg.decode=True) on the model's device.
    ``prompt_len`` is accepted for signature compatibility; the cache is
    statically sized by ``cfg.max_decode_len`` alone."""
    from ..models.llama import init_decode_cache

    return init_decode_cache(model.cfg, batch, device=model.lm_head.weight.device)


def load_params(
    cfg,
    *,
    config: str,
    device,
    restore: str | None = None,
    jax_params=None,
    quantize: str | None = None,
    init_host: bool = False,
    compare_unquantized: bool = False,
    seed: int = 0,
    log=print,
    tag: str = "generate",
):
    """Build the serving model for ``cfg`` on ``device``: random init from
    ``seed`` (flax's distributions), the ``params`` of the newest checkpoint
    under ``restore`` (a trained run's ``TPUJOB_CHECKPOINT_DIR``; only
    ``params.pt`` is read, and every name and shape must be ``cfg``'s), or
    the weights of a JAX param tree (``jax_params``, nested dicts of arrays)
    through ``params_from_jax``. The matmul weights and the embedding are
    then cast to ``cfg.dtype`` once, so no decode step casts a weight: a
    restored model is cast or quantized exactly as a fresh one.

    ``quantize="int8"`` (which ``cfg.quantize`` must equal) quantizes the
    full-precision weights with ``ops.quantize`` and builds an int8 model; a
    JAX tree already quantized by ``quantize_tree`` is carried across as it
    is. ``init_host`` builds the full-precision model and quantizes it on
    the CPU, so only the int8 state reaches ``device`` as a whole: each
    weight is drawn with ``device``'s generator and moved to the host one at
    a time, so one seed gives the same weights with and without the flag
    (the reference's ``jax.random`` does the same). Otherwise the full-precision model is freed
    once quantized, unless ``compare_unquantized`` keeps it as the control:
    the bf16 serving model on the same weights, with ``cfg``'s
    ``kv_quantize``.

    Returns ``(model, n_params)``, followed by the control with
    ``compare_unquantized`` and then the restored step with ``restore``."""
    if init_host and not quantize:
        # Host init exists for models whose full-precision weights do not
        # fit the card; unquantized, they would not fit after the copy either.
        raise ValueError("init_host requires quantize='int8'")
    if cfg.quantize != quantize:
        raise ValueError(f"cfg.quantize={cfg.quantize!r} but quantize={quantize!r}")
    if compare_unquantized and (not quantize or init_host):
        # The same-call A/B needs both models resident, which is what
        # init_host exists to avoid.
        raise ValueError("compare_unquantized requires quantize and not init_host")
    if restore is not None and jax_params is not None:
        raise ValueError("restore and jax_params are exclusive")
    device = torch.device(device)
    fp_cfg = dataclasses.replace(cfg, quantize=None)
    init_dev = torch.device("cpu") if init_host else device
    control = None
    restored_step = None
    t0 = time.perf_counter()
    if jax_params is not None and quantize and is_quantized_tree(jax_params):
        if compare_unquantized:
            raise ValueError("compare_unquantized needs the full-precision JAX tree")
        sd = params_from_jax(jax_params, cfg)
        src = "JAX int8 param tree"
    else:
        fp = llama_lib.Llama(fp_cfg, device=init_dev)
        if restore is not None:
            restored_step, params = _restore_params(restore, fp, config)
            fp.load_state_dict(params)
            del params
            src = f"trained checkpoint, step {restored_step}"
            log(f"[{tag}] restored params from {restore} (step {restored_step})")
        elif jax_params is not None:
            fp.load_state_dict(params_from_jax(jax_params, fp_cfg))
            src = "JAX param tree"
        else:
            fp.init_weights(torch.Generator(device=device).manual_seed(seed))
            src = "random init — no tokenizer here"
        if not quantize:
            model = fp
        else:
            sd = quant_lib.quantize_state_dict(fp.state_dict())
            control = fp if compare_unquantized else None
            del fp
    if quantize:
        model = llama_lib.Llama(cfg, device="meta")
        model.load_state_dict({k: v.to(device) for k, v in sd.items()}, assign=True)
        del sd
    model.cast_matmul_weights_().requires_grad_(False).eval()
    sd = model.state_dict()
    n_params = sum(t.numel() for name, t in sd.items() if not name.endswith(".scale"))
    log(f"[{tag}] config={config}: {n_params / 1e6:.1f}M params ({src})")
    if quantize:
        log(
            f"[{tag}] int8 weight-only quantization: "
            f"{quant_lib.state_bytes(sd) / 1e9:.2f} GB on {device_name(device)} "
            f"(f32 would be {4 * n_params / 1e9:.2f} GB) +{time.perf_counter() - t0:.1f}s"
        )
    out = (model, n_params)
    if compare_unquantized:
        out += (control.cast_matmul_weights_().requires_grad_(False).eval(),)
    if restore is not None:
        out += (restored_step,)
    return out


def _restore_params(restore: str, like, config: str):
    """``(step, params)`` of the newest checkpoint under ``restore``: the
    ``params`` alone (the optimizer's moments, twice their bytes, are never
    read), checked name by name and shape by shape against ``like``'s state
    dict. Shapes only: a checkpoint trained with bf16 parameters serves too."""
    with CheckpointManager(restore, create=False) as mgr:
        try:
            step, params = mgr.restore_subtree("params")
        except KeyError as e:
            raise ValueError(f"checkpoint under {restore} has no 'params': {e}") from None
    expected = {k: tuple(v.shape) for k, v in like.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in params.items()}
    for name in sorted(expected.keys() | got.keys()):
        if expected.get(name) != got.get(name):
            raise ValueError(
                f"checkpoint params don't match --config {config} at {like.cfg.n_layers} "
                f"layers: first mismatch at "
                f"{name}: checkpoint has {got.get(name, 'nothing')}, config expects "
                f"{expected.get(name, 'nothing')}"
            )
    return step, params


def run(
    *,
    config: str = "tiny",
    n_layers: int | None = None,
    batch_size: int = 8,
    prompt_len: int = 64,
    max_new_tokens: int = 64,
    max_decode_len: int | None = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    quantize: str | None = None,
    kv_quantize: str | None = None,
    init_host: bool = False,
    compare_unquantized: bool = False,
    restore: str | None = None,
    seed: int = 0,
    device=None,
    log=print,
) -> dict:
    dev = world_device(device)
    n_dev = joined_world()[1]
    cfg = getattr(llama_lib, llama_lib.CONFIGS[config])(
        decode=True,
        max_decode_len=max_decode_len or (prompt_len + max_new_tokens),
        quantize=quantize,
        kv_quantize=kv_quantize,
        **({} if n_layers is None else {"n_layers": n_layers}),
    )
    log(
        f"[generate] config={config} d_model={cfg.d_model} "
        f"layers={cfg.n_layers} batch={batch_size} prompt={prompt_len} "
        f"new={max_new_tokens} T={temperature} attn={cfg.attn_impl} "
        f"quantize={quantize} kv_quantize={kv_quantize} ({device_name(dev)})"
    )
    model, n_params, *extra = load_params(
        cfg, config=config, device=dev, restore=restore, quantize=quantize,
        init_host=init_host, compare_unquantized=compare_unquantized, seed=seed, log=log,
    )
    control = extra[0] if compare_unquantized else None
    restored_step = extra[-1] if restore is not None else None
    prompt = torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch_size, prompt_len)),
        dtype=torch.long,
    ).to(dev)

    def timed(run_model, label):
        """First generation (kernel build included), then the best of 3.
        Reps reuse the cache (every slot the mask reads is rewritten first).
        Returns (seconds, flash launches of one call, cache)."""
        gen = make_generate(
            run_model, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p,
        )
        cache = init_cache(run_model, batch_size, prompt_len)

        def generate_once(rep: int):
            generator = torch.Generator(device=dev).manual_seed(seed + rep)
            toks, _ = gen(cache, prompt, generator)
            synchronize(dev)
            return toks

        t0 = time.perf_counter()
        launches0 = flash_lib.launch_count
        toks = generate_once(0)
        launches = flash_lib.launch_count - launches0
        log(f"[generate] {label}: first generation (kernel build included) +{time.perf_counter() - t0:.1f}s")
        if toks.shape != (batch_size, max_new_tokens) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size
        ):
            raise RuntimeError(
                f"generated tokens of shape {tuple(toks.shape)} outside [0, {cfg.vocab_size})"
            )
        best = float("inf")
        for rep in range(3):
            t0 = time.perf_counter()
            generate_once(rep + 1)
            best = min(best, time.perf_counter() - t0)
        return best, launches, cache

    dt, flash_launches, cache = timed(model, quantize or "full-precision")
    prefill_s = float("inf")
    with torch.no_grad():
        for _ in range(3):
            t0 = time.perf_counter()
            llama_lib.decode_forward(model, cache, prompt)
            synchronize(dev)
            prefill_s = min(prefill_s, time.perf_counter() - t0)
    del cache
    # Same-call A/B: the full-precision control over the same prompt, cache
    # setting and loop.
    dt_fp = timed(control, "full-precision control")[0] if control is not None else None

    new_tokens = batch_size * max_new_tokens
    tps = new_tokens / dt
    rendezvous.report_first_step(0)
    rendezvous.report_metrics(
        max_new_tokens, decode_tokens_per_sec=tps, decode_tokens_per_sec_per_chip=tps / n_dev,
    )
    log(
        f"[generate] {new_tokens} new tokens in {dt:.3f}s: {tps:,.0f} tokens/sec "
        f"({1000 * dt / max_new_tokens:.2f} ms/step at batch {batch_size}); "
        f"prefill {1000 * prefill_s:.2f} ms; {flash_launches} flash launches per call"
    )
    result = {
        "metric": "llama_decode_tokens_per_sec_per_chip",
        "value": round(tps / n_dev, 1),
        "unit": "tokens/sec/chip",
        "config": config,
        "params_m": round(n_params / 1e6, 1),
        "batch": batch_size,
        "prompt_len": prompt_len,
        "max_new_tokens": max_new_tokens,
        "max_decode_len": cfg.max_decode_len,
        "devices": n_dev,
        "device": device_name(dev),
        "generate_s": dt,
        "prefill_s": prefill_s,
        "flash_launches_per_generate": flash_launches,
    }
    if quantize:
        result["quantize"] = quantize
        result["weight_mb"] = round(quant_lib.state_bytes(model.state_dict()) / 1e6, 2)
    if kv_quantize:
        result["kv_quantize"] = kv_quantize
    if restored_step is not None:
        result["restored_step"] = restored_step
    if dt_fp is not None:
        result["generate_s_unquantized"] = dt_fp
        result["tokens_per_sec_per_chip_unquantized"] = round(new_tokens / dt_fp / n_dev, 1)
        result["int8_speedup"] = round(dt_fp / dt, 3)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", choices=sorted(llama_lib.CONFIGS), default="tiny")
    p.add_argument(
        "--layers", type=int, default=None, dest="n_layers",
        help="the preset's depth cut to this many layers (as llama_train --layers; "
        "a checkpoint must have been trained at the same depth)",
    )
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument(
        "--max-decode-len", type=int, default=None,
        help="static cache length (default prompt+new); larger values "
        "measure serving at a context budget",
    )
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument(
        "--top-k", type=int, default=0,
        help="sample only from the k highest-probability tokens "
        "(0 = off; needs --temperature > 0)",
    )
    p.add_argument(
        "--top-p", type=float, default=1.0,
        help="nucleus sampling: smallest token set reaching this "
        "cumulative probability (1.0 = off; needs --temperature > 0)",
    )
    p.add_argument(
        "--quantize", choices=["int8"], default=None,
        help="weight-only quantization: matmul weights, embedding and head "
        "held int8 on the device with per-row scales, dequantized one layer "
        "at a time at the use site (ops/quantize.py)",
    )
    p.add_argument(
        "--kv-quantize", choices=["int8"], default=None,
        help="store the KV cache int8 with per-(token, kv head) scales: "
        "half the cache memory of bf16",
    )
    p.add_argument(
        "--init-host", action="store_true",
        help="initialize and quantize on the host CPU and copy only the int8 "
        "state to the device (for models whose full-precision weights exceed "
        "its memory); the weights are those of the same --seed without it; "
        "requires --quantize",
    )
    p.add_argument(
        "--compare-unquantized", action="store_true",
        help="also time the full-precision (bf16) model on the same weights "
        "in the same call (the int8 A/B); requires --quantize",
    )
    p.add_argument(
        "--restore", default=None, metavar="CKPT_DIR",
        help="serve a trained checkpoint: restore params from the newest step "
        "under this directory (a llama_train run's TPUJOB_CHECKPOINT_DIR)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; TPUJOB_PLATFORM=cpu also selects the CPU",
    )
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    world = rendezvous.initialize_from_env(device=args.device)
    result = run(
        config=args.config,
        n_layers=args.n_layers,
        batch_size=args.batch_size,
        prompt_len=args.prompt_len,
        max_new_tokens=args.max_new_tokens,
        max_decode_len=args.max_decode_len,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        quantize=args.quantize,
        kv_quantize=args.kv_quantize,
        init_host=args.init_host,
        compare_unquantized=args.compare_unquantized,
        restore=args.restore,
        seed=args.seed,
        device=args.device,
        log=lambda msg: print(msg, flush=True),
    )
    if args.json and world.process_id == 0:
        print(json.dumps(result), flush=True)
    rendezvous.finalize(world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
