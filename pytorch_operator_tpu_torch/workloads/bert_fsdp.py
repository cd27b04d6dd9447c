"""BERT sequence-classification fine-tune with FSDP parameter sharding — the
port of ``pytorch_operator_tpu/workloads/bert_fsdp.py``.

``models/bert.BertClassifier`` (``bert_tiny``, or BERT-base with
``--bert-base``) trained with AdamW (weight decay 0.01 on every parameter,
optax's ``adamw``; with ``--lr-warmup-steps`` a linear warmup then cosine
decay over ``steps + max(warmup, 1)``; ``--grad-clip`` a global-norm clip)
on a synthetic two-topic set (:func:`synthetic_topic_batch`: class c draws
its tokens from the c-th part of the vocabulary, so the accuracy shows real
learning). The mesh is ``--mesh``, else ``TPUJOB_MESH``, else ``fsdp=-1``,
over any of JAX's axes, as JAX's ``bert_fsdp`` runs on any mesh:

- ``tp`` is tensor parallelism (``models/bert.py``): each rank holds its
  blocks of the heads, ``d_ff`` and the vocabulary, the rest whole; after
  the backward the gradients of the tensors tp holds whole are averaged
  over tp, so that the copies stay equal bit for bit where the card's
  kernels sum in no fixed order. A tp that does not divide ``n_heads``,
  ``d_ff`` or the vocabulary is refused, naming the dim.
- ``sp``, ``ep`` and ``pp`` split no BERT parameter and no batch row in
  JAX: their ranks are replicas here, reading the same rows, every
  gradient averaged over them after the backward (a deliberate
  difference: JAX splits sp's activations over the sequence).
- over ``dp`` and ``fsdp`` each encoder layer and the root are FSDP2 units
  (``parallel/sharding.shard_model``, one data mesh a coordinate of the
  other axes), parameters and AdamW's moments sharded on dim 0, each data
  coordinate training on its rows of the global batch (rounded to a
  multiple of the ranks).

The loop is ``trainer.throughput_loop``; ``--prefetch`` feeds through a
``DevicePrefetcher``, ``--profile-dir`` traces the timed window.

The result carries the JAX keys (``bert_train_sequences_per_sec_per_chip``
over the world's size), plus ``device``, ``peak_mem_bytes`` (the card's,
None on the CPU), every step's ``losses`` and ``accuracies``, ``step_s``,
this rank's ``param_bytes`` and ``optimizer_state_bytes``, ``mesh`` (the
axes and sizes), ``world`` and ``backend``; ``run(keep_params=True)`` adds
``params``, the trained parameters whole on every rank
(``sharding.full_state_dict``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime import rendezvous


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


def _replica_groups(model, mesh) -> list:
    """``(params, n, group)`` for each mean that keeps the model's copies
    equal after the backward: the tensors tp holds whole over tp, every
    parameter over each axis the model is whole over (sp, ep, pp)."""
    from ..parallel.mesh import axis_sizes
    from ..parallel.sharding import model_splits

    if mesh is None:
        return []
    sizes = axis_sizes(mesh)
    out = []
    if model.tp is not None:
        whole = [p for name, p in model.named_parameters()
                 if all(d is None for _, d in model_splits(model, name))]
        out.append((whole, model.tp.size, mesh.get_group("tp")))
    for axis in model.REPLICATED_AXES:
        if sizes.get(axis, 1) > 1:
            out.append((list(model.parameters()), sizes[axis], mesh.get_group(axis)))
    return out


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
    keep_params: bool = False,
    device=None,
    log=print,
) -> dict:
    """The fine-tune (``main`` and the tests use it). ``init_params``: one
    process's state dict to start from (``models/convert.bert_params_from_jax``;
    a tp rank loads its blocks of it), else the init seeded by
    ``TPUJOB_SEED`` (default 0), as the JAX workload's; every rank builds
    the same values before sharding."""
    from ..models import bert as bert_lib
    from ..parallel import data as data_lib
    from ..parallel import mesh as mesh_lib
    from ..parallel.collectives import world as joined_world
    from ..parallel.sharding import (Block, full_state_dict, local_nbytes, model_splits, shard_model,
                                    take_block)
    from ..runtime.device import device_name, world_device
    from .trainer import make_optimizer, mean_all_reduce_, throughput_loop, world_mean

    _, n_dev = joined_world()
    backend = torch.distributed.get_backend() if n_dev > 1 else None
    dev = world_device(device)
    mesh_spec = mesh_spec or mesh_lib.mesh_spec_from_env()
    axes = mesh_lib.hybrid_axis_sizes(mesh_spec, n_dev)  # refuses sizes that are not the world's
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
                                    seed=int(os.environ.get("TPUJOB_SEED", "0")), mesh=mesh)
    if init_params is not None:
        model.load_state_dict({name: take_block(t, model_splits(model, name))
                               for name, t in init_params.items()})
    model.to(dev)
    model.train()
    # The whole model's count (a tp rank's blocks as their whole tensors).
    n_params = sum(math.prod(Block.of(p, model_splits(model, name)).shape)
                   for name, p in model.named_parameters())
    if mesh is not None:
        shard_model(model, mesh)
    replicas = _replica_groups(model, mesh)
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
        for params, n, group in replicas:
            mean_all_reduce_([p.grad for p in params], n, group)
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
        **({"params": full_state_dict(model)} if keep_params else {}),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--bert-base", action="store_true", help="real BERT-base dims")
    p.add_argument(
        "--mesh", default=None,
        help='axes over the world\'s ranks, e.g. "fsdp=2", "dp=2", "fsdp=2,tp=2" (default: '
        "TPUJOB_MESH or fsdp=-1): tp splits the heads, d_ff and the vocabulary; sp, ep and pp "
        "ranks are replicas",
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
