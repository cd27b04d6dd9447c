"""ResNet-50 throughput benchmark and training workload — the port of
``pytorch_operator_tpu/workloads/resnet_bench.py``.

The north-star metric (BASELINE.json:2): images/sec/chip on ResNet-50, on
synthetic images (``workloads/datasets.synthetic_images``) or a packed file
(``--data-file``, through the native loader, optionally ``--prefetch``). The
step is the reference's: SGD with nesterov momentum 0.9 (optax's
``sgd(lr, momentum, nesterov=True)``: ``torch.optim.SGD(nesterov=True)``
starts its buffer at the first gradient, optax at zero plus the gradient:
the same updates), batch-norm statistics updated in the forward,
cross-entropy on f32 logits with label smoothing 0.1, bf16 compute. Steps
run in chunks of ``min(30, steps)``, the timed steps rounded up to whole
chunks and the warmup to whole chunks; the timing is
``trainer.timed_windows``' (fenced windows with the min estimator, then the
sustained windows with depth-1 lookahead); every fence is a host read of
the loss.

In a world of several processes (the supervisor's Master and Workers) the
global batch rounds down to a multiple of the ranks, each rank trains on its
rows, the gradients are averaged across the ranks, and each batch norm
all-reduces its sums, so that the statistics and the running buffers are the
global batch's, as JAX's batch norm under ``jit`` on its dp mesh computes
them. The result carries the JAX keys, plus ``device``, ``peak_mem_bytes``
(the card's, None on the CPU), ``memory_format`` (the conv weights' layout:
``channels_last`` on the card) and ``losses`` (every step's, warmup
included).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from ..runtime import rendezvous

LABEL_SMOOTHING = 0.1


def build_model(depth: int, *, classes: int, device, bn_f32_stats: bool = True,
                s2d_stem: bool = False, world: int = 1):
    """ResNet-``depth`` from seed 0 (the JAX bench's key-0 init, in
    distribution) on ``device`` (``channels_last`` on a card), with batch
    norm synchronised across the ranks when ``world > 1``."""
    from ..models import resnet as resnet_lib

    return resnet_lib.BY_DEPTH[depth](
        num_classes=classes, bn_f32_stats=bn_f32_stats, s2d_stem=s2d_stem, sync_stats=world > 1,
        device=device,
    )


def make_train_step(model, *, lr: float, momentum: float, world: int = 1,
                    label_smoothing: float = LABEL_SMOOTHING):
    """``(train_step(images, labels) -> loss, optimizer)``: one SGD-nesterov
    step of ``model`` on this rank's rows, in place; the loss is the global
    batch's mean (a device tensor)."""
    from .trainer import average_gradients_, world_mean

    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum, nesterov=True)
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(bx, by):
        logits = model(bx, train=True)
        loss = F.cross_entropy(logits, by, label_smoothing=label_smoothing)
        loss.backward()
        average_gradients_(params, world)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return world_mean(loss.detach(), world)

    return train_step, opt


def run_benchmark(
    *,
    depth: int = 50,
    batch_size: int = 128,
    image_size: int = 224,
    classes: int = 1000,
    steps: int = 30,
    warmup: int = 5,
    lr: float = 0.1,
    momentum: float = 0.9,
    windows: int = 1,
    data_file: str | None = None,
    prefetch: int = 0,
    prefetch_depth_max: int = 0,
    feed_autotune: bool = False,
    prefetch_workers: int = 0,
    profile_dir: str | None = None,
    bn_f32_stats: bool = True,
    s2d_stem: bool = False,
    device=None,
    log=print,
) -> dict:
    """The benchmark harness (``main`` and tests use it). ``data_file``
    trains from a packed file, every step on its own batch, and the
    throughput includes the input pipeline; the image geometry comes from the
    file and ``classes`` is checked against its labels."""
    from ..parallel.collectives import world as joined_world
    from ..runtime.device import device_name, world_device
    from .datasets import synthetic_images
    from .trainer import chunk_plan, image_bench_loop, open_image_feed, probe_image_file

    rank, n_dev = joined_world()
    dev = world_device(device)
    file_meta = field_x = None
    if data_file:
        file_meta, field_x = probe_image_file(data_file)
        if field_x is not None:
            image_size = field_x.shape[0]
    batch = max(batch_size // n_dev, 1) * n_dev
    geometry = "x".join(str(s) for s in field_x.shape[:2]) + "px" if field_x is not None else f"{image_size}px"
    log(
        f"[resnet] ResNet-{depth} on {n_dev} device(s) ({device_name(dev)}), global batch "
        f"{batch}, {geometry}" + (f", data file {data_file}" if data_file else " (synthetic)")
    )
    model = build_model(depth, classes=classes, bn_f32_stats=bn_f32_stats, s2d_stem=s2d_stem,
                        device=dev, world=n_dev)
    train_step, _ = make_train_step(model, lr=lr, momentum=momentum, world=n_dev)
    chunk, _, _ = chunk_plan(steps, warmup)

    loader = None
    if data_file:
        next_batches, loader = open_image_feed(
            data_file, batch=batch, chunk=chunk, classes=classes, device=dev, meta=file_meta,
            prefetch=prefetch, prefetch_depth_max=prefetch_depth_max, autotune=feed_autotune,
            prefetch_workers=prefetch_workers,
        )
    else:
        # bf16 pixels: the model's first op casts anyway.
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
                             profile_dir=profile_dir, tag="resnet", log=log)
    finally:
        if loader is not None:
            loader.close()
    from ..models.resnet import memory_format

    steps, dt, dt_sustained, final_loss = r["steps"], r["dt"], r["dt_sustained"], r["losses"][-1]
    min_window_per_chip = batch * steps / dt / n_dev if dt is not None else None
    sustained_steps = steps * r["n_win"]
    images_per_sec = batch * sustained_steps / dt_sustained
    per_chip = images_per_sec / n_dev
    step_ms = 1000.0 * dt_sustained / sustained_steps
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    rendezvous.report_metrics(
        sustained_steps, images_per_sec=images_per_sec, images_per_sec_per_chip=per_chip,
    )
    log(
        f"[resnet] sustained {sustained_steps} steps in {dt_sustained:.2f}s: "
        f"{images_per_sec:.1f} images/sec total, {per_chip:.1f} images/sec/chip, "
        f"{step_ms:.1f} ms/step, loss={final_loss:.3f} "
        + (f"(min fenced window: {min_window_per_chip:.1f})" if min_window_per_chip is not None
           else "(fenced windows skipped: profiling)")
    )
    return {
        "metric": f"resnet{depth}_train_images_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "images/sec/chip",
        "images_per_sec_total": round(images_per_sec, 2),
        "step_time_ms": round(step_ms, 2),
        "min_window_images_per_sec_per_chip": (
            round(min_window_per_chip, 2) if min_window_per_chip is not None else None
        ),
        "global_batch": batch,
        "devices": n_dev,
        "final_loss": round(final_loss, 4),
        "input": "file" if data_file else "synthetic",
        "device": device_name(dev),
        "peak_mem_bytes": peak,
        "losses": r["losses"],
        "memory_format": str(memory_format(model)).replace("torch.", ""),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch-size", type=int, default=128, help="global batch")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--steps", type=int, default=30, help="timed steps")
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--depth", type=int, default=50, choices=[18, 34, 50, 101, 152])
    p.add_argument(
        "--bn-bf16-stats", action="store_true",
        help="EXPERIMENTAL: batch-norm statistics AND learnable scale/bias in bf16 "
        "(as flax stores stats in param_dtype); default f32",
    )
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument(
        "--s2d-stem", action="store_true",
        help="compute the stem as a space-to-depth 4x4 conv (exact transform of the "
        "7x7/2 stem; same params/checkpoints)",
    )
    p.add_argument(
        "--windows", type=int, default=1,
        help="time this many windows of --steps: the headline value is the sustained "
        "throughput over all of them (one fence at the end, depth-1 lookahead); the "
        "fastest fenced window is also reported",
    )
    p.add_argument(
        "--data-file", default=None,
        help="train from a packed image file through the native loader (pack with "
        "pytorch_operator_tpu_torch.data.pack); throughput then includes the input pipeline",
    )
    p.add_argument(
        "--prefetch", type=int, default=None, metavar="DEPTH",
        help="with --data-file: keep DEPTH stacked chunks on the device ahead of the "
        "step loop (pulls, stacking cast and copy on a feed thread; 0 = inline). "
        "Default: spec.data_plane / TPUJOB_PREFETCH",
    )
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the timed window here")
    p.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; TPUJOB_PLATFORM=cpu also selects the CPU",
    )
    p.add_argument("--json", action="store_true", help="print a JSON result line")
    from .trainer import add_feed_tuning_args, data_plane_env_defaults, resolve_feed_tuning

    add_feed_tuning_args(p)
    args = p.parse_args(argv)

    _, env_prefetch = data_plane_env_defaults()
    feed_tuning = resolve_feed_tuning(args)
    world = rendezvous.initialize_from_env(device=args.device)
    result = run_benchmark(
        depth=args.depth,
        batch_size=args.batch_size,
        image_size=args.image_size,
        classes=args.classes,
        steps=args.steps,
        warmup=args.warmup,
        lr=args.lr,
        momentum=args.momentum,
        windows=args.windows,
        data_file=args.data_file,
        prefetch=args.prefetch if args.prefetch is not None else env_prefetch,
        prefetch_depth_max=feed_tuning["prefetch_depth_max"],
        feed_autotune=feed_tuning["autotune"],
        prefetch_workers=feed_tuning["prefetch_workers"],
        profile_dir=args.profile_dir,
        bn_f32_stats=not args.bn_bf16_stats,
        s2d_stem=args.s2d_stem,
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
