"""ViT training throughput benchmark and workload — the port of
``pytorch_operator_tpu/workloads/vit_bench.py``.

Companion to ``resnet_bench`` (the same chunks, windows and fences,
``trainer.image_bench_loop``) for the transformer vision family: AdamW
(lr 1e-3, weight decay 0.05 on every parameter, as ``optax.adamw``) through
``trainer.Optimizer``, cross-entropy on f32 logits with label smoothing 0.1.
``--attn-impl flash`` runs the flash kernels non-causal at head dim 64 (each
of the three once a layer a step; the 197 tokens of a 224-px image pad to
256 with the padded keys masked). In a world of several processes each rank
trains on its rows of the global batch and the gradients are averaged. The
result carries the JAX keys plus ``device``, ``peak_mem_bytes`` and ``losses``
(every step's, warmup included).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from ..runtime import rendezvous

LABEL_SMOOTHING = 0.1
WEIGHT_DECAY = 0.05


def make_train_step(model, *, lr: float, world: int = 1, label_smoothing: float = LABEL_SMOOTHING):
    """``(train_step(images, labels) -> loss, optimizer)``: one AdamW step of
    ``model`` on this rank's rows, in place; the loss is the global batch's
    mean (a device tensor)."""
    from .trainer import average_gradients_, make_optimizer, world_mean

    opt = make_optimizer(model.parameters(), lr, weight_decay=WEIGHT_DECAY)

    def train_step(bx, by):
        loss = F.cross_entropy(model(bx), by, label_smoothing=label_smoothing)
        loss.backward()
        average_gradients_(opt.params, world)
        opt.step()
        return world_mean(loss.detach(), world)

    return train_step, opt


def run_benchmark(
    *,
    variant: str = "b16",
    batch_size: int = 128,
    image_size: int = 224,
    classes: int = 1000,
    steps: int = 30,
    warmup: int = 5,
    lr: float = 1e-3,
    windows: int = 1,
    attn_impl: str = "dense",
    remat: bool = False,
    remat_policy: str = "full",
    data_file: str | None = None,
    prefetch: int = 0,
    prefetch_depth_max: int = 0,
    feed_autotune: bool = False,
    prefetch_workers: int = 0,
    profile_dir: str | None = None,
    device=None,
    log=print,
) -> dict:
    """The benchmark harness (``main`` and tests use it): ViT-``variant``
    from seed 0 (the JAX bench's key-0 init, in distribution)."""
    from ..models import vit as vit_lib
    from ..parallel.collectives import world as joined_world
    from ..runtime.device import device_name, world_device
    from .datasets import synthetic_images
    from .trainer import chunk_plan, image_bench_loop, open_image_feed, probe_image_file

    if remat_policy != "full" and not remat:
        # Measuring the no-remat path while the caller believes the selective
        # policy is on would be a trap.
        raise ValueError(f"--remat-policy {remat_policy} has no effect without --remat")
    rank, n_dev = joined_world()
    dev = world_device(device)
    file_meta = None
    if data_file:
        # Geometry from the file; open_image_feed validates it (H == W).
        file_meta, field_x = probe_image_file(data_file)
        if field_x is not None:
            image_size = field_x.shape[0]
    cfg = vit_lib.BY_NAME[variant](
        image_size=image_size, num_classes=classes, attn_impl=attn_impl,
        remat=remat, remat_policy=remat_policy,
    )
    model = vit_lib.ViT(cfg, device=dev)
    batch = max(batch_size // n_dev, 1) * n_dev
    log(
        f"[vit] ViT-{variant} d={cfg.d_model} depth={cfg.depth} on {n_dev} device(s) "
        f"({device_name(dev)}), global batch {batch}, {image_size}px, attn={attn_impl}"
        + (f", data file {data_file}" if data_file else " (synthetic)")
    )
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[vit] {n_params / 1e6:.1f}M params")
    train_step, _ = make_train_step(model, lr=lr, world=n_dev)
    chunk, _, _ = chunk_plan(steps, warmup)

    loader = None
    if data_file:
        next_batches, loader = open_image_feed(
            data_file, batch=batch, chunk=chunk, classes=classes, device=dev, square=True,
            meta=file_meta, prefetch=prefetch, prefetch_depth_max=prefetch_depth_max,
            autotune=feed_autotune, prefetch_workers=prefetch_workers,
        )
    else:
        hx, hy = synthetic_images(batch, image_size, image_size, classes)
        rows = slice(rank * batch // n_dev, (rank + 1) * batch // n_dev)
        gx = torch.from_numpy(hx[rows]).to(torch.bfloat16).to(dev)
        gy = torch.from_numpy(hy[rows]).long().to(dev)

        def next_batches():
            return gx, gy

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        r = image_bench_loop(train_step, next_batches, steps=steps, warmup=warmup,
                             windows=windows, batch=batch, world=n_dev,
                             profile_dir=profile_dir, tag="vit", log=log)
    finally:
        if loader is not None:
            loader.close()
    steps, dt, dt_sustained, final_loss = r["steps"], r["dt"], r["dt_sustained"], r["losses"][-1]
    sustained_steps = steps * r["n_win"]
    images_per_sec = batch * sustained_steps / dt_sustained
    per_chip = images_per_sec / n_dev
    min_window = batch * steps / dt / n_dev if dt is not None else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    rendezvous.report_metrics(
        sustained_steps, images_per_sec=images_per_sec, images_per_sec_per_chip=per_chip,
    )
    log(
        f"[vit] sustained {sustained_steps} steps in {dt_sustained:.2f}s: "
        f"{per_chip:.1f} images/sec/chip, {1000 * dt_sustained / sustained_steps:.1f} ms/step, "
        f"loss={final_loss:.3f} "
        + (f"(min fenced window: {min_window:.1f})" if min_window is not None
           else "(fenced windows skipped: profiling)")
    )
    return {
        "metric": f"vit_{variant}_train_images_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "images/sec/chip",
        "min_window_images_per_sec_per_chip": round(min_window, 2) if min_window is not None else None,
        "params_m": round(n_params / 1e6, 1),
        "global_batch": batch,
        "devices": n_dev,
        "final_loss": round(final_loss, 4),
        "input": "file" if data_file else "synthetic",
        "device": device_name(dev),
        "peak_mem_bytes": peak,
        "losses": r["losses"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--variant", choices=sorted("s16 b16 l16".split()), default="b16")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument(
        "--remat", action="store_true",
        help="recompute each encoder block in the backward (torch.utils.checkpoint): "
        "~1/3 more FLOPs for O(depth) activation memory",
    )
    p.add_argument(
        "--remat-policy", choices=("full", "dots"), default="full",
        help="with --remat: 'full' recomputes whole blocks; 'dots' saves the GEMM "
        "outputs so the backward does not recompute them (more memory)",
    )
    p.add_argument("--windows", type=int, default=1)
    p.add_argument("--attn-impl", choices=("dense", "flash"), default="dense")
    p.add_argument(
        "--data-file", default=None,
        help="train from a packed image file through the native loader (pack with "
        "pytorch_operator_tpu_torch.data.pack); the geometry comes from the file and "
        "the throughput includes the input pipeline",
    )
    p.add_argument(
        "--prefetch", type=int, default=None, metavar="DEPTH",
        help="with --data-file: keep DEPTH stacked chunks on the device ahead of the "
        "step loop (0 = inline). Default: spec.data_plane / TPUJOB_PREFETCH",
    )
    p.add_argument("--profile-dir", default=None)
    p.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; TPUJOB_PLATFORM=cpu also selects the CPU",
    )
    p.add_argument("--json", action="store_true")
    from .trainer import add_feed_tuning_args, data_plane_env_defaults, resolve_feed_tuning

    add_feed_tuning_args(p)
    args = p.parse_args(argv)

    _, env_prefetch = data_plane_env_defaults()
    feed_tuning = resolve_feed_tuning(args)
    world = rendezvous.initialize_from_env(device=args.device)
    result = run_benchmark(
        variant=args.variant,
        batch_size=args.batch_size,
        image_size=args.image_size,
        classes=args.classes,
        steps=args.steps,
        warmup=args.warmup,
        lr=args.lr,
        windows=args.windows,
        attn_impl=args.attn_impl,
        remat=args.remat,
        remat_policy=args.remat_policy,
        data_file=args.data_file,
        prefetch=args.prefetch if args.prefetch is not None else env_prefetch,
        prefetch_depth_max=feed_tuning["prefetch_depth_max"],
        feed_autotune=feed_tuning["autotune"],
        prefetch_workers=feed_tuning["prefetch_workers"],
        profile_dir=args.profile_dir,
        device=args.device,
        log=lambda msg: print(
            f"[rank {world.process_id}/{world.num_processes}] {msg}"
            if world.num_processes > 1 else msg,
            flush=True,
        ),
    )
    if args.json and world.process_id == 0:
        print(json.dumps(result), flush=True)
    rendezvous.finalize(world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
