"""MNIST-style training workload — the port of
``pytorch_operator_tpu/workloads/mnist_train.py``.

The digit CNN (``models/mnist.DigitCNN``, bf16 compute over f32
parameters) trained with Adam (the port's ``trainer.Optimizer``, weight
decay 0: optax's ``adam``) on the real 8×8 digits
(``workloads/datasets.digits``), data-parallel over the joined world as the
JAX workload's ``dp`` mesh: parameters whole on every rank, each rank its
rows of the global batch (``parallel/data.global_batch``), the gradients
averaged across the ranks (``trainer.average_gradients_``). The global
batch is ``--batch-size`` capped by the training records and rounded down
to a multiple of the ranks. Batches come from the in-memory set
(``parallel/data.epoch_batches``, seed ``seed + epoch``) or from a packed
file (``--data-file``, ``pack --dataset digits``) through the native loader,
``--prefetch`` on a device feed. Evaluation runs the whole test split as one
padded batch, each rank counting its rows, the counts summed over the
world.

Exit code: 0 if the final test accuracy is at least ``--target-acc``, else
1 (the job's Succeeded condition then means "trained to target").
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime import rendezvous


def run(
    *,
    epochs: int = 8,
    batch_size: int = 128,
    lr: float = 2e-3,
    seed: int = 0,
    data_file: str | None = None,
    prefetch: int = 0,
    prefetch_depth_max: int = 0,
    feed_autotune: bool = False,
    prefetch_workers: int = 0,
    init_params: dict | None = None,
    dtype=torch.bfloat16,
    device=None,
    log=print,
) -> dict:
    """Train and evaluate; the result holds ``test_accuracy``, ``steps``,
    every step's loss (the global batch's), ``first_step_s`` (from the call
    to the first step's loss on the host), ``images_per_sec`` over the
    steps after the first and ``global_batch``; ``error`` (and no training)
    when the records cannot form a global batch. ``init_params``: a state
    dict to start from (``models/convert.mnist_params_from_jax``), else the
    seeded init. ``dtype``: the compute dtype (the JAX workload's bf16; f32
    for the tests' exact comparisons)."""
    from .. import obs
    from ..models.mnist import DigitCNN
    from ..parallel.collectives import world as joined_world
    from ..parallel.data import epoch_batches, global_batch
    from ..runtime.device import device_name, world_device
    from .datasets import digits
    from .trainer import (
        Optimizer,
        ProgressHeartbeat,
        average_gradients_,
        heartbeat_reporter,
        world_mean,
    )

    t0 = time.time()
    rank, dp = joined_world()
    dev = world_device(device)
    log(f"[mnist] rank {rank}/{dp}: {device_name(dev)}, dp={dp}")
    x_train, y_train = digits("train")
    x_test, y_test = digits("test")
    # The global batch divides over the ranks and fits the training records
    # (the packed file's with --data-file; the in-memory set then only
    # serves evaluation).
    n_train = len(x_train)
    if data_file:
        from ..data import read_meta

        n_train = read_meta(data_file).n_records
    batch = (min(batch_size, n_train) // dp) * dp
    if batch == 0:
        msg = (f"training set ({n_train} records) smaller than the dp extent ({dp}); "
               "cannot form a global batch")
        log(f"[mnist] error: {msg}")
        return {"error": msg}

    model = DigitCNN(dtype=dtype, seed=seed)
    if init_params is not None:
        model.load_state_dict(init_params)
    model.to(dev)
    params = list(model.parameters())
    opt = Optimizer(params, lr, schedule="constant", warmup_steps=0, decay_steps=None,
                    grad_clip=None, weight_decay=0.0)

    def train_step(bx, by):
        loss = F.cross_entropy(model(bx), by)
        loss.backward()
        average_gradients_(params, dp)
        opt.step()
        return world_mean(loss.detach(), dp)

    def rows(x, y):
        # This rank's rows of a global batch.
        return (np.ascontiguousarray(global_batch(x)),
                np.ascontiguousarray(global_batch(y)).astype(np.int64))

    def put_xy(x, y):
        return tuple(torch.from_numpy(a).to(dev) for a in rows(x, y))

    loader = None
    if data_file:
        from ..data import open_training_loader

        loader = open_training_loader(data_file, batch, seed=seed, processes=dp)
        if loader.batches_per_epoch == 0:
            loader.close()
            msg = f"{data_file} holds fewer records than the global batch ({batch}); zero steps per epoch"
            log(f"[mnist] error: {msg}")
            return {"error": msg}
        if prefetch > 0:
            # The slot copy and the host-to-device transfer ride the feed
            # threads; the step loop pops batches already on the device.
            from ..data.device_prefetch import prefetch_to_device, to_device

            loader = prefetch_to_device(
                loader, depth=prefetch, put=lambda f: to_device(rows(f["x"], f["y"]), dev),
                depth_max=prefetch_depth_max or None, workers=max(prefetch_workers, 1),
                autotune=feed_autotune,
            )

            def epoch_iter(epoch):
                for _ in range(loader.batches_per_epoch):
                    yield loader.next_batch()[2]

        else:

            def epoch_iter(epoch):
                for _ in range(loader.batches_per_epoch):
                    _, _, fields = loader.next_batch()
                    yield put_xy(fields["x"], fields["y"])

    else:

        def epoch_iter(epoch):
            for bx, by in epoch_batches(x_train, y_train, batch, seed=seed + epoch):
                yield put_xy(bx, by)

    # The live heartbeat (the shared throttle); None standalone.
    hb = ProgressHeartbeat(
        heartbeat_reporter(rendezvous.report_progress, batch=batch, n_dev=dp,
                           unit="images/sec/chip", feed=loader)
        if rendezvous.progress_enabled() else None
    )
    step = 0
    losses = []
    first_step_s = t_first = None
    try:
        for epoch in range(epochs):
            for gx, gy in epoch_iter(epoch):
                with obs.span("step", cat="step", step=step):
                    losses.append(train_step(gx, gy))
                if step == 0:
                    float(losses[-1])  # a real fence
                    first_step_s = time.time() - t0
                    t_first = time.perf_counter()
                    rendezvous.report_first_step(step)
                    log(f"[mnist] first step done at +{first_step_s:.2f}s")
                    # The clock started before the data load and the first
                    # step; a rate over that window would read as a stall.
                    hb.reset(1)
                step += 1
                hb.tick(step, lambda: float(losses[-1]))
            if losses:
                rendezvous.report_metrics(step, epoch=epoch, loss=float(losses[-1]))
    finally:
        if loader is not None:
            loader.close()
    losses = [float(x) for x in losses]
    dt = time.perf_counter() - t_first if t_first is not None else 0.0

    # The whole test split as one padded global batch; each rank counts the
    # correct answers in its rows.
    n_eval = len(x_test)
    pad = (-n_eval) % dp
    xp = np.concatenate([x_test, np.zeros((pad,) + x_test.shape[1:], x_test.dtype)])
    yp = np.concatenate([y_test, np.zeros((pad,), y_test.dtype)])
    mask = np.concatenate([np.ones(n_eval, bool), np.zeros(pad, bool)])
    ex, ey = put_xy(xp, yp)
    with torch.no_grad():
        hit = (model(ex).argmax(-1) == ey) & torch.from_numpy(global_batch(mask)).to(dev)
        correct = hit.sum()
    if dp > 1:
        torch.distributed.all_reduce(correct)
    acc = int(correct) / n_eval
    rendezvous.report_metrics(step, test_accuracy=acc)
    ips = batch * (step - 1) / dt if step > 1 and dt > 0 else None
    log(f"[mnist] rank {rank}: steps={step} test_accuracy={acc:.4f}"
        + (f", {ips:.1f} images/sec after the first step" if ips else ""))
    return {
        "test_accuracy": acc,
        "steps": step,
        "losses": losses,
        "first_step_s": first_step_s,
        "images_per_sec": ips,
        "global_batch": batch,
        "devices": dp,
        "device": device_name(dev),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=128, help="global batch size")
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--target-acc", type=float, default=0.97)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--data-file", default=None,
        help="stream train batches from a packed array file through the native loader "
        "(pack with pytorch_operator_tpu_torch.data.pack --dataset digits) instead of the "
        "in-memory dataset",
    )
    p.add_argument(
        "--prefetch", type=int, default=None, metavar="DEPTH",
        help="with --data-file: keep DEPTH batches on the device ahead of the step loop "
        "(0 = inline transfers). Default: spec.data_plane / TPUJOB_PREFETCH",
    )
    p.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; TPUJOB_PLATFORM=cpu also selects the CPU",
    )
    p.add_argument("--json", action="store_true", help="print the result as a JSON line (rank 0)")
    from .trainer import add_feed_tuning_args, data_plane_env_defaults, resolve_feed_tuning

    add_feed_tuning_args(p)
    args = p.parse_args(argv)
    _, env_prefetch = data_plane_env_defaults()
    feed_tuning = resolve_feed_tuning(args)
    world = rendezvous.initialize_from_env(device=args.device)
    result = run(
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        seed=args.seed,
        data_file=args.data_file,
        prefetch=args.prefetch if args.prefetch is not None else env_prefetch,
        prefetch_depth_max=feed_tuning["prefetch_depth_max"],
        feed_autotune=feed_tuning["autotune"],
        prefetch_workers=feed_tuning["prefetch_workers"],
        device=args.device,
        log=lambda msg: print(msg, flush=True),
    )
    ok = "error" not in result and result["test_accuracy"] >= args.target_acc
    if "error" not in result:
        print(f"[mnist] test_accuracy={result['test_accuracy']:.4f} (target {args.target_acc})",
              flush=True)
    if args.json and world.process_id == 0:
        print(json.dumps(result), flush=True)
    code = 0 if ok else 1
    rendezvous.finalize(world, code)  # a world of several processes exits here
    return code


if __name__ == "__main__":
    sys.exit(main())
