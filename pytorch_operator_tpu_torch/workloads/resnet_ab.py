"""Interleaved A/B of ResNet variants in one process — the port of
``pytorch_operator_tpu/workloads/resnet_ab.py``.

A card's speed drifts within a session, so back-to-back processes cannot
resolve small effects. This harness builds every variant in one process and
alternates timed windows A, B, ..., A, B, ...; drift hits every variant
alike, and the fastest window of each gives a same-instant comparison.

Usage::

    python -m pytorch_operator_tpu_torch.workloads.resnet_ab --variants plain,s2d --rounds 6

The result has the JAX keys, plus each variant's ``first_loss`` (its first
step's loss: variants that compute the same function from the same seed,
``plain`` and ``s2d``, start equal) and ``device``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

# name -> ResNet model kwargs overriding the benchmark defaults.
# A variant may carry a per-variant global batch: "plain@256".
VARIANTS = {
    "plain": {},
    "s2d": {"s2d_stem": True},
    "bn-bf16": {"bn_f32_stats": False},
    "s2d+bn-bf16": {"s2d_stem": True, "bn_f32_stats": False},
}


def parse_variant(spec: str):
    """'name@batch' -> (spec, model_kwargs, batch_override)."""
    name, _, b = spec.partition("@")
    if name not in VARIANTS:
        raise SystemExit(f"unknown variant {name!r}; have {list(VARIANTS)}")
    return spec, VARIANTS[name], int(b) if b else None


def run_ab(
    *,
    variant_names,
    depth: int = 50,
    batch_size: int = 128,
    image_size: int = 224,
    classes: int = 1000,
    steps: int = 30,
    rounds: int = 6,
    lr: float = 0.1,
    momentum: float = 0.9,
    device=None,
    log=print,
) -> dict:
    from ..parallel.collectives import world as joined_world
    from ..runtime.device import device_name, world_device
    from .datasets import synthetic_images
    from .resnet_bench import build_model, make_train_step

    rank, n_dev = joined_world()
    dev = world_device(device)
    parsed = [parse_variant(s) for s in variant_names]
    log(
        f"[ab] ResNet-{depth} base batch {batch_size} {image_size}px on {device_name(dev)}; "
        f"variants: {', '.join(variant_names)}"
    )

    runs = {}
    batches = {}
    for spec, kwargs, batch_override in parsed:
        batch = max((batch_override or batch_size) // n_dev, 1) * n_dev
        if batch not in batches:
            hx, hy = synthetic_images(batch, image_size, image_size, classes)
            rows = slice(rank * batch // n_dev, (rank + 1) * batch // n_dev)
            batches[batch] = (torch.from_numpy(hx[rows]).to(torch.bfloat16).to(dev),
                              torch.from_numpy(hy[rows]).long().to(dev))
        gx, gy = batches[batch]
        model = build_model(depth, classes=classes, device=dev, world=n_dev, **kwargs)
        step, _ = make_train_step(model, lr=lr, momentum=momentum, world=n_dev)

        def window(step=step, gx=gx, gy=gy):
            for _ in range(steps):
                loss = step(gx, gy)
            return loss

        t0 = time.time()
        first_loss = float(step(gx, gy))
        for _ in range(steps - 1):
            loss = step(gx, gy)
        float(loss if steps > 1 else first_loss)
        log(f"[ab] {spec}: built and warm in {time.time() - t0:.1f}s")
        runs[spec] = {"window": window, "batch": batch, "dt": math.inf, "loss": None,
                      "first_loss": first_loss}

    for r in range(rounds):
        for spec, v in runs.items():
            t0 = time.time()
            v["loss"] = float(v["window"]())
            v["dt"] = min(v["dt"], time.time() - t0)
        log(
            f"[ab] round {r + 1}/{rounds}: "
            + "  ".join(f"{s}={runs[s]['batch'] * steps / runs[s]['dt']:.0f}" for s in runs)
        )

    base = variant_names[0]
    base_ips = runs[base]["batch"] * steps / runs[base]["dt"]
    out = {"steps_per_window": steps, "rounds": rounds, "device": device_name(dev)}
    for spec, v in runs.items():
        ips = v["batch"] * steps / v["dt"]
        out[spec] = {
            "images_per_sec_per_chip": round(ips / n_dev, 1),
            "batch": v["batch"],
            "vs_first": round(ips / base_ips, 4),
            "final_loss": round(v["loss"], 4),
            "first_loss": v["first_loss"],
        }
        log(
            f"[ab] {spec}: {ips / n_dev:.1f} img/s/chip "
            f"({out[spec]['vs_first']:.3f}x vs {base}), loss {v['loss']:.4f}"
        )
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--variants", default="plain,s2d")
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--steps", type=int, default=30, help="steps per window")
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; TPUJOB_PLATFORM=cpu also selects the CPU",
    )
    args = p.parse_args(argv)
    names = [n.strip() for n in args.variants.split(",") if n.strip()]
    for n in names:
        parse_variant(n)  # validate early
    from ..runtime import rendezvous

    world = rendezvous.initialize_from_env(device=args.device)
    out = run_ab(
        variant_names=names,
        depth=args.depth,
        batch_size=args.batch_size,
        image_size=args.image_size,
        steps=args.steps,
        rounds=args.rounds,
        device=args.device,
        log=lambda m: print(m, file=sys.stderr, flush=True),
    )
    if world.process_id == 0:
        print(json.dumps(out), flush=True)
    rendezvous.finalize(world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
