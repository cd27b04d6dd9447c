"""BERT sequence-classification fine-tune with FSDP parameter sharding — the
port of ``pytorch_operator_tpu/workloads/bert_fsdp.py``.

``models/bert.BertClassifier`` (``bert_tiny``, or BERT-base with
``--bert-base``) trained with AdamW (weight decay 0.01 on every parameter,
optax's ``adamw``; with ``--lr-warmup-steps`` a linear warmup then cosine
decay over ``steps + max(warmup, 1)``; ``--grad-clip`` a global-norm clip)
on a synthetic two-topic set (:func:`synthetic_topic_batch`: class c draws
its tokens from the c-th part of the vocabulary, so the accuracy shows real
learning). The mesh is ``--mesh``, else ``TPUJOB_MESH``, else ``fsdp=-1``:
over ``dp`` and ``fsdp`` each encoder layer and the root are FSDP2 units
(``parallel/sharding.shard_model``), parameters and AdamW's moments sharded
on dim 0, each rank training on its rows of the global batch (rounded to a
multiple of the ranks). ``tp``, ``sp``, ``ep`` and ``pp`` are refused by
name (:data:`ITEM_BERT_TP`): the JAX model shards heads, mlp and vocab over
``tp``, which the port does not yet. The loop is ``trainer.throughput_loop``;
``--prefetch`` feeds through a ``DevicePrefetcher``, ``--profile-dir``
traces the timed window.

The result carries the JAX keys (``bert_train_sequences_per_sec_per_chip``
over the world's size), plus ``device``, ``peak_mem_bytes`` (the card's,
None on the CPU), every step's ``losses`` and ``accuracies``, ``step_s``,
this rank's ``param_bytes`` and ``optimizer_state_bytes``, ``mesh``,
``world`` and ``backend``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime import rendezvous

ITEM_BERT_TP = "ROADMAP.md Queue 1, BERT under tp"


def synthetic_topic_batch(batch: int, seq_len: int, vocab: int, step: int, n_classes: int = 2):
    """Class c ⇒ tokens uniform over [c·vocab/n, (c+1)·vocab/n): the JAX
    function's numpy draws, so one step gives the same bytes in both
    packages."""
    rng = np.random.default_rng(step)
    labels = rng.integers(0, n_classes, size=(batch,), dtype=np.int32)
    width = vocab // n_classes
    low = labels[:, None] * width
    toks = rng.integers(0, width, size=(batch, seq_len)).astype(np.int32) + low
    return toks.astype(np.int32), labels


def resolve_bert_mesh(spec: str, world: int) -> dict:
    """The axes and sizes of mesh ``spec`` over ``world`` ranks; an axis
    other than ``dp`` and ``fsdp`` of more than one rank (or ``-1``) is
    refused by name before the sizes are resolved."""
    from ..parallel import mesh as mesh_lib

    sizes = mesh_lib.parse_mesh_spec(spec)
    other = [a for a, n in sizes.items() if a not in mesh_lib.DATA_AXES and n != 1]
    if other:
        raise NotImplementedError(
            f"bert_fsdp over {', '.join(other)} is not ported yet ({ITEM_BERT_TP}); "
            "use dp and fsdp"
        )
    return mesh_lib.hybrid_axis_sizes(spec, world)


def run(
    *,
    bert_base: bool = False,
    mesh_spec: str | None = None,
    batch_size: int = 16,
    seq_len: int = 64,
    steps: int = 30,
    warmup: int = 2,
    lr: float = 1e-4,
    lr_warmup_steps: int = 0,
    grad_clip: float | None = None,
    num_classes: int = 2,
    prefetch: int = 0,
    prefetch_depth_max: int = 0,
    feed_autotune: bool = False,
    prefetch_workers: int = 0,
    profile_dir: str | None = None,
    init_params: dict | None = None,
    device=None,
    log=print,
) -> dict:
    """The fine-tune (``main`` and the tests use it). ``init_params``: a
    state dict to start from (``models/convert.bert_params_from_jax``), else
    the init seeded by ``TPUJOB_SEED`` (default 0), as the JAX workload's;
    every rank builds the same values before sharding."""
    from ..models import bert as bert_lib
    from ..parallel import data as data_lib
    from ..parallel import mesh as mesh_lib
    from ..parallel.collectives import world as joined_world
    from ..parallel.sharding import local_nbytes, shard_model
    from ..runtime.device import device_name, world_device
    from .trainer import make_optimizer, throughput_loop, world_mean

    _, n_dev = joined_world()
    backend = torch.distributed.get_backend() if n_dev > 1 else None
    dev = world_device(device)
    mesh_spec = mesh_spec or mesh_lib.mesh_spec_from_env()
    axes = resolve_bert_mesh(mesh_spec, n_dev)
    mesh = mesh_lib.make_mesh(mesh_spec, dev.type) if n_dev > 1 else None
    coords = mesh_lib.train_coords(mesh)
    cfg = bert_lib.bert_base() if bert_base else bert_lib.bert_tiny()
    batch = max(batch_size // n_dev, 1) * n_dev if batch_size % n_dev else batch_size
    log(
        f"[bert] {'base' if bert_base else 'tiny'} d_model={cfg.d_model} layers={cfg.n_layers} "
        f"mesh={axes} batch={batch} seq={seq_len} ({device_name(dev)}"
        f"{f', {backend}' if backend else ''})"
    )

    t_init = time.time()
    model = bert_lib.BertClassifier(cfg, num_classes=num_classes,
                                    seed=int(os.environ.get("TPUJOB_SEED", "0")))
    if init_params is not None:
        model.load_state_dict(init_params)
    model.to(dev)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    if mesh is not None:
        shard_model(model, mesh)
    log(f"[bert] {n_params / 1e6:.1f}M params, init +{time.time() - t_init:.1f}s")
    opt = make_optimizer(
        model, lr, schedule="cosine" if lr_warmup_steps > 0 else "constant",
        warmup_steps=lr_warmup_steps, decay_steps=steps + max(warmup, 1),
        grad_clip=grad_clip, weight_decay=0.01,
    )
    accuracies = []

    def train_step(tokens_labels):
        tokens, labels = tokens_labels
        logits = model(tokens)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        opt.step()
        accuracies.append(world_mean((logits.detach().argmax(-1) == labels).float().mean(), n_dev, mesh))
        return world_mean(loss.detach(), n_dev, mesh)

    def host_batch(step: int):
        toks, labels = synthetic_topic_batch(batch, seq_len, cfg.vocab_size, step, num_classes)
        return (data_lib.global_batch(toks, coords.data_index, coords.data_extent).astype(np.int64),
                data_lib.global_batch(labels, coords.data_index, coords.data_extent).astype(np.int64))

    prefetcher = None
    if prefetch > 0:
        # Batch N+1 reaches the device on the feed threads while step N
        # runs; the producer counts the steps the loop would pass.
        import itertools

        from ..data.device_prefetch import DevicePrefetcher, to_device

        feed_steps = itertools.count(0)
        prefetcher = DevicePrefetcher(
            lambda: host_batch(next(feed_steps)), put=lambda b: to_device(b, dev),
            depth=prefetch, depth_max=prefetch_depth_max or None,
            workers=max(prefetch_workers, 1), autotune=feed_autotune,
        )

        def batches(step: int):
            return prefetcher.get()

    else:

        def batches(step: int):
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host_batch(step))

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    seqs_per_step_per_chip = batch / n_dev
    try:
        losses, steps_per_sec, end_step = throughput_loop(
            train_step, batches, steps=steps, warmup=warmup,
            on_first_step=lambda: rendezvous.report_first_step(0),
            log=lambda m: log(f"[bert] {m}"), profile_dir=profile_dir,
            progress=(
                (lambda s, loss, sps: rendezvous.report_progress(
                    s, loss=loss, steps_per_sec=sps, throughput=sps * seqs_per_step_per_chip,
                    unit="sequences/sec/chip"))
                if rendezvous.progress_enabled() else None
            ),
        )
    finally:
        if prefetcher is not None:
            prefetcher.close()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    losses = [float(x) for x in losses]
    accuracies = [float(x) for x in accuracies]
    final_loss, final_acc = losses[-1], accuracies[-1]
    seqs_per_sec = steps_per_sec * batch
    per_chip = seqs_per_sec / n_dev
    rendezvous.report_metrics(
        end_step, sequences_per_sec=seqs_per_sec, sequences_per_sec_per_chip=per_chip,
        final_loss=final_loss, final_accuracy=final_acc,
    )
    log(
        f"[bert] {steps} steps: {seqs_per_sec:,.1f} seq/sec ({per_chip:,.1f}/chip), "
        f"loss {final_loss:.3f}, batch acc {final_acc:.2f}"
        + (f", peak memory {peak / 2**30:.2f} GiB" if peak is not None else "")
    )
    return {
        "metric": "bert_train_sequences_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "sequences/sec/chip",
        "model": "bert-base" if bert_base else "bert-tiny",
        "params_m": round(n_params / 1e6, 1),
        "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "final_loss": round(final_loss, 4),
        "final_accuracy": round(final_acc, 4),
        "devices": n_dev,
        "device": device_name(dev),
        "peak_mem_bytes": peak,
        "losses": losses,
        "accuracies": accuracies,
        "step_s": 1.0 / steps_per_sec if steps_per_sec else None,
        "param_bytes": local_nbytes(model.parameters()),
        "optimizer_state_bytes": opt.state_nbytes(),
        "mesh": axes,
        "world": n_dev,
        "backend": backend,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--bert-base", action="store_true", help="real BERT-base dims")
    p.add_argument(
        "--mesh", default=None,
        help='axes over the world\'s ranks: dp and fsdp, e.g. "fsdp=2", "dp=2" (default: '
        f"TPUJOB_MESH or fsdp=-1); tp, sp, ep and pp are refused ({ITEM_BERT_TP})",
    )
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument(
        "--lr-warmup-steps", type=int, default=0,
        help="linear warmup to --lr then cosine decay (0 = constant lr)",
    )
    p.add_argument("--grad-clip", type=float, default=None, help="clip gradients to this global norm")
    p.add_argument(
        "--prefetch", type=int, default=None, metavar="DEPTH",
        help="keep DEPTH batches on the device ahead of the step loop (0 = inline transfers). "
        "Default: spec.data_plane / TPUJOB_PREFETCH",
    )
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the timed window here")
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
    result = run(
        bert_base=args.bert_base,
        mesh_spec=args.mesh,
        batch_size=args.batch_size,
        seq_len=args.seq_len,
        steps=args.steps,
        warmup=args.warmup,
        lr=args.lr,
        lr_warmup_steps=args.lr_warmup_steps,
        grad_clip=args.grad_clip,
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
