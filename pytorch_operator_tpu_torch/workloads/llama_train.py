"""Llama causal-LM training on one GPU or over a world of processes — the
port of ``pytorch_operator_tpu/workloads/llama_train.py``.

The llama presets default to ``attn_impl="flash"`` and ``xent_impl="chunked"``,
so every step runs the flash forward kernel and both backward kernels once per
layer (ops/flash_attention.py) and the chunked-vocab loss (ops/chunked_xent.py),
with f32 master weights and bf16 compute, AdamW and an optional cosine schedule
or optax's adafactor (``--optimizer adafactor``) (workloads/trainer.py),
optionally with each block rematerialised (``--remat``, ``--remat-policy``).
Data is the JAX workload's synthetic affine-bigram stream (token[t+1] =
(5·token[t] + 3) mod V), or packed token records (``--data-file``,
``--eval-file``) read by the native loader, inline or through a device feed
that runs ahead of the step loop (``--prefetch`` and its tuning flags). With
``--checkpoint-every`` it saves into the supervisor-injected checkpoint
directory, blocking or off the step loop (``--async-checkpoint``), and
resumes from it after a restart. ``--preempt-at`` dies with the retryable
exit code 138 on a replica's first life (a simulated preemption);
``--profile-dir`` writes a ``torch.profiler`` trace of the timed window.
``--experts N`` trains the mixture-of-experts Llama (``--moe-top-k``,
``--moe-dispatch dense|sparse``, ``--moe-capacity-factor``,
``--moe-aux-weight``), its experts over the mesh's ``ep`` axis, or every
expert on each rank without one.

In a world of several processes (the supervisor's Master and Workers, joined
by ``runtime.rendezvous.initialize_from_env``) ``--mesh``/``TPUJOB_MESH``
(default ``fsdp=-1``) lays the model out over the ranks: ``tp`` splits each
layer's heads and ``d_ff``, the embedding's and the head's vocabulary
(``parallel/sharding.py``'s rule table; the loss is vocab-parallel);
``ep`` splits the MoE layers' experts; ``sp`` splits the sequence, each rank
computing its block of ``S/sp`` positions with ``--attn-impl ring`` or
``ulysses`` (``parallel/ring.py``, ``parallel/ulysses.py``), its gradients
averaged over sp; ``pp`` splits the layers into stages (``parallel/pipeline.py``:
``--pp-schedule gpipe`` or ``1f1b`` over ``--pp-microbatches``, default 2·pp),
the embedding on stage 0 and the head's vocabulary rows over the stages;
``fsdp`` shards parameters (tp's and ep's blocks, a stage's tensors),
gradients and the optimizer's state with FSDP2, ``dp`` replicates them (both
together: HSDP; ``@dcn`` axes outermost). ``--batch-size`` is the global
batch; each data coordinate (``parallel/mesh.train_coords``) trains on its
rows of it (with ``--grad-accum A``, or on a pp mesh, its rows of each of
the global batch's A or ``--pp-microbatches`` microbatches, as JAX's
accumulation and pipeline split it), the ranks of one tp, ep, sp or pp
group on the same rows, and the losses reported are the global batch's.
Sparse MoE dispatch groups the tokens of every data and sp rank of
the step (or of the microbatch) as JAX groups the global batch's
(``parallel/moe.py``). AdamW and adafactor both run in a
world, in f32 or bf16 parameters (``--param-dtype``).

    python -m pytorch_operator_tpu_torch.workloads.llama_train --config 0.3b \\
        --batch-size 4 --seq-len 4096 --steps 5 --json

``pp`` composes with the other axes: a stage's layers are tp, ep or sp
blocks (sp with ``--attn-impl`` dense or flash, every sp rank computing the
whole sequence: JAX refuses ring and ulysses inside the pipeline), the
head's vocabulary rows are cut by pp and then by tp inside each stage, and
the loss tail is vocab-parallel over both.

It runs on ``cuda`` unless ``--device cpu`` or ``TPUJOB_PLATFORM=cpu`` asks
for the host; with neither and no GPU it raises. A tp that does not divide
the heads, kv heads, ``d_ff`` or the vocabulary is refused as JAX's
``llama_train`` refuses it (its partitioner's ValueError).
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager, job_checkpoint_dir
from ..data import field_range, open_training_loader, read_meta
from ..data.device_prefetch import DevicePrefetcher, to_device
from ..models import llama as llama_lib
from ..models.convert import params_from_jax
from ..parallel.sharding import check_tp_divides, model_axes
from ..ops import flash_attention as flash_lib
from ..parallel import data as data_lib
from ..parallel import mesh as mesh_lib
from ..parallel import ulysses as ulysses_lib
from ..parallel.collectives import world as joined_world
from ..parallel.pipeline import check_split
from ..parallel.sharding import full_state_dict, local_nbytes, model_blocks, shard_model
from ..runtime import rendezvous
from ..runtime.device import device_name, world_device
from .trainer import (
    add_feed_tuning_args,
    data_plane_env_defaults,
    heartbeat_reporter,
    make_lm_eval_step,
    make_lm_train_step,
    make_optimizer,
    resolve_feed_tuning,
    throughput_loop,
    world_mean,
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


def resolve_train_mesh(spec: str, world: int) -> dict:
    """The axes and sizes, in layout order, of mesh ``spec`` resolved
    against ``world`` ranks (one device a process), with the JAX package's
    errors."""
    return mesh_lib.hybrid_axis_sizes(spec, world)


def check_pp_microbatches(batch: int, microbatches: int, pp: int, data_extent: int) -> int:
    """``microbatches``, once the pipeline can split the global ``batch``
    into them as JAX's does (``pipeline.check_split``: JAX's checks and
    messages) and the data coordinates can split each microbatch's rows
    evenly (JAX's XLA would replicate them; a port rank feeds its share of
    each)."""
    check_split(batch, microbatches, pp)
    if (batch // microbatches) % data_extent:
        raise ValueError(
            f"the data extent {data_extent} must divide each of the {microbatches} "
            f"microbatches' {batch // microbatches} rows (the global batch {batch})"
        )
    return microbatches


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
    async_checkpoint: bool = False,
    prefetch: int = 0,
    prefetch_depth_max: int = 0,
    feed_autotune: bool = False,
    prefetch_workers: int = 0,
    max_steps: int | None = None,
    remat: bool | None = None,
    remat_policy: str | None = None,
    donate: bool | None = None,
    grad_accum: int = 1,
    n_layers: int | None = None,
    param_dtype: str | None = None,
    n_experts: int | None = None,
    moe_top_k: int | None = None,
    moe_dispatch: str | None = None,
    moe_capacity_factor: float | None = None,
    moe_aux_weight: float | None = None,
    attn_impl: str | None = None,
    xent_impl: str | None = None,
    preempt_at: int | None = None,
    profile_dir: str | None = None,
    mesh_spec: str | None = None,
    pp_microbatches: int | None = None,
    pp_schedule: str = "gpipe",
    device=None,
    seed: int = 0,
    init_params=None,
    keep_params: bool = False,
    log=print,
) -> dict:
    """Train ``config`` for ``warmup`` + ``steps`` steps and return the JAX
    workload's result keys plus ``step_s``, ``losses`` (every step, warmup
    included), ``peak_mem_bytes`` (the card's, None on the CPU),
    ``flash_launches_per_step``, ``optimizer``, ``optimizer_state_bytes``
    (the optimizer's state tensors at the end) and ``device``; with
    ``data_file`` also ``loader`` (``"native"`` or ``"python"``, the loader
    that ran), with ``prefetch`` also ``feed`` (the prefetcher's
    ``stats()``), with saves in the loop ``save_s`` (each in-loop save's
    return time: the step loop's stall), with ``donate`` given ``donate`` (a
    no-op here), with ``n_experts`` > 1 also ``n_experts``, ``moe_dispatch``
    and ``active_params_m`` (the non-expert parameters plus top_k/E of the
    expert banks for sparse dispatch, all of them for dense), with
    ``moe_aux_weight`` > 0 also ``aux_losses`` (the load-balance loss of
    every step, a mean over layers and microbatches). Weights are a random init
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
    the run resumes from the newest verified checkpoint there (weights, the
    optimizer's state and count, the data stream fast-forwarded), saves every
    ``checkpoint_every`` steps and at its end; ``max_steps`` is the global
    step budget across such lives. ``async_checkpoint`` commits the in-loop
    saves off the step loop (a staged snapshot: copies issued before
    ``save()`` returns, waited for on the writer's thread); the manager's
    close commits the last one before the run returns.

    ``prefetch`` > 0 builds a :class:`DevicePrefetcher` of that depth after
    the resume and the data fast-forward: ``prefetch_workers`` producer
    threads (at least 1), ``feed_autotune`` within ``prefetch_depth_max``.
    The batches and their order are the inline path's. ``preempt_at``: on
    the first life (``TPUJOB_RESTART_COUNT`` 0), exit 138 through
    ``os._exit`` when the step about to run reaches it, after flushing the
    output; nothing else runs (no in-flight save commits). ``profile_dir``
    profiles the timed window (:func:`trainer.maybe_profile`).

    In a joined world of more than one process (``torch.distributed``
    initialized: ``main`` joins the supervisor's world, a test its own) the
    run lays the model out on ``mesh_spec`` (default ``TPUJOB_MESH``, else
    ``fsdp=-1``: ``parallel/mesh.mesh_spec_from_env``; see
    :func:`resolve_train_mesh`): a tp rank builds its blocks of the same
    init (``init_weights`` draws each whole tensor; ``params_from_jax``
    takes the rank's block), then FSDP2 shards them over the data axes
    (``parallel/sharding.shard_model``). ``batch_size`` is the global batch
    (rounded to a multiple of the ranks, as the JAX workload rounds it to
    its devices); each data coordinate takes its rows
    (``parallel/data.global_batch``), and ``losses``/``eval_loss`` are the
    global batch's means. On a pp mesh each step runs ``pp_schedule``
    ("gpipe" or "1f1b") over ``pp_microbatches`` microbatches (default
    2·pp) of the global batch, JAX's: microbatch m is the m-th of M
    consecutive blocks, and a data coordinate holds its rows of each (the
    held-out batches too). The result adds ``world``, ``mesh``,
    ``backend``, this rank's ``param_bytes`` and ``optimizer_state_bytes``,
    and ``per_rank`` (each rank's data, tp, sp, ep and pp coordinates, bytes,
    peak memory, flash launches and ``tp_head_gathers``, ulysses' gathers of
    q, k and v over tp); on a pp mesh also ``pp_schedule`` and
    ``pp_microbatches``. A resize record from the supervisor is
    polled every step (``rendezvous.poll_resize``): the rank drains its
    loader, feed and saves, then re-executes into the new world.
    ``keep_params`` adds ``params``: the trained parameters whole on every
    rank (gathered from the shards), CPU tensors in state-dict order."""
    rank, world = joined_world()
    backend = torch.distributed.get_backend() if world > 1 else None
    dev = world_device(device)
    mesh_spec = mesh_spec or mesh_lib.mesh_spec_from_env()
    axes = resolve_train_mesh(mesh_spec, world)
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
    if moe_dispatch is not None and moe_dispatch not in ("dense", "sparse"):
        raise ValueError(f"moe_dispatch={moe_dispatch!r} not in ('dense', 'sparse')")
    for key, value in (
        ("n_experts", n_experts), ("moe_top_k", moe_top_k), ("moe_dispatch", moe_dispatch),
        ("moe_capacity_factor", moe_capacity_factor), ("moe_aux_weight", moe_aux_weight),
    ):
        if value is not None:
            over[key] = value
    cfg = getattr(llama_lib, CONFIGS[config])(**over)
    if remat_policy not in (None, "full") and not cfg.remat:
        # Measuring the no-remat path while the caller believes the
        # selective policy is on would mislead ('full' without remat is
        # inert and allowed, as in JAX).
        raise ValueError(f"--remat-policy {remat_policy} has no effect without --remat")
    # The routing, checked up front (else a bad top_k surfaces deep in the
    # first forward).
    if cfg.n_experts > 0 and not (1 <= cfg.moe_top_k <= cfg.n_experts):
        raise ValueError(
            f"moe_top_k={cfg.moe_top_k} must lie in [1, n_experts={cfg.n_experts}] — pass "
            "--moe-top-k to adjust the routing"
        )
    if cfg.moe_aux_weight > 0 and cfg.n_experts == 0:
        raise ValueError(
            "--moe-aux-weight needs a MoE model (pass --experts N); without experts no "
            "router exists, so the aux loss would be silently inert"
        )
    # The global batch, rounded to a multiple of the ranks as the JAX
    # workload rounds it to its devices (every device of the mesh, tp's too).
    if batch_size % world:
        batch_size = max(batch_size // world, 1) * world
    if cfg.n_experts > 0:
        if cfg.moe_dispatch == "sparse" and not cfg.moe_aux_weight:
            # LlamaConfig warns library users; repeat it in the job log.
            log(
                "[llama] WARNING: --moe-dispatch sparse with no --moe-aux-weight: an "
                "unbalanced router collapses onto a few experts and capacity-factor "
                "dispatch then DROPS most tokens. Pass --moe-aux-weight 1e-2."
            )
        if axes.get("ep", 1) > 1:
            log(
                f"[llama] n_experts={cfg.n_experts} top_k={cfg.moe_top_k} "
                f"dispatch={cfg.moe_dispatch}: {cfg.n_experts // axes['ep']} experts a rank "
                f"over ep={axes['ep']}"
            )
        elif world > 1:
            log(
                f"[llama] WARNING: n_experts={cfg.n_experts} but the mesh has no ep axis — "
                f"experts run replicated on every device (dense fallback). Use e.g. "
                f'--mesh "dp={max(world // cfg.n_experts, 1)},ep={cfg.n_experts}".'
            )
        else:
            log(
                f"[llama] n_experts={cfg.n_experts} top_k={cfg.moe_top_k} "
                f"dispatch={cfg.moe_dispatch}: every expert runs on this one card"
            )
    if axes.get("sp", 1) > 1 and cfg.attn_impl not in ("ring", "ulysses"):
        log(
            f"[llama] WARNING: sp={axes['sp']} with attn_impl={cfg.attn_impl}: every sp rank "
            "computes the whole sequence; --attn-impl ring or ulysses splits it"
        )
    check_tp_divides(cfg, axes.get("tp", 1))
    mesh = mesh_lib.make_mesh(mesh_spec, dev.type) if world > 1 else None
    # The rows this rank trains on: the ranks of one tp, ep or sp group
    # share them.
    coords = mesh_lib.train_coords(mesh)
    if grad_accum > 1 and batch_size % grad_accum:
        raise ValueError(f"--grad-accum {grad_accum} must divide the global batch {batch_size}")
    if grad_accum > 1 and (batch_size // coords.data_extent) % grad_accum:
        raise ValueError(
            f"--grad-accum {grad_accum} must divide each data coordinate's "
            f"{batch_size // coords.data_extent} rows"
        )
    pp = axes.get("pp", 1)
    # The global batch's microbatches, of which a data coordinate feeds its
    # rows of each (parallel/data.global_batch): the pipeline's on a pp mesh
    # (JAX refuses grad_accum there), else grad_accum's.
    feed_microbatches = grad_accum
    if pp > 1:
        pp_microbatches = pp_microbatches or 2 * pp
        feed_microbatches = check_pp_microbatches(batch_size, pp_microbatches, pp, coords.data_extent)
    log(
        f"[llama] config={config} d_model={cfg.d_model} layers={cfg.n_layers} "
        f"mesh={axes}{f' pp_schedule={pp_schedule} microbatches={pp_microbatches}' if pp > 1 else ''} "
        f"attn={cfg.attn_impl} xent={cfg.xent_impl} "
        f"remat={cfg.remat and cfg.remat_policy} batch={batch_size} seq={seq_len} "
        f"({device_name(dev)}{f', {backend}' if backend else ''})"
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
        return open_training_loader(path, batch_size, seed=seed, processes=world), meta

    def host_tokens(ldr):
        # A copy out of the loader's slot: the native loader recycles it at
        # the next next_batch(), and nothing here may outlive it.
        _, _, fields = ldr.next_batch()
        return np.array(fields["tokens"][:, :seq_len], np.int32, copy=True)

    def next_tokens(ldr):
        # This data coordinate's rows of the next global batch, on its
        # device: on a pp mesh its share of each of the eval step's
        # microbatches.
        return data_lib.put_global(host_tokens(ldr), dev, coords.data_index, coords.data_extent,
                                   pp_microbatches if pp > 1 else 1).long()

    if eval_file:
        # Before any training compute: a bad eval file must not cost a
        # finished run its result.
        if eval_batches < 1:
            raise ValueError(f"eval_batches must be >= 1, got {eval_batches}")
        open_token_file(eval_file, "--eval-file", seed=1, do_open=False)

    t_init = time.time()
    # Every rank of a tp or ep coordinate builds the same values (one seed,
    # or the same tree) before sharding: each then keeps its shard of them.
    # A tp or ep rank builds its blocks only, a pp rank its stage's tensors.
    model = llama_lib.Llama(cfg, device=dev, mesh=mesh)
    if init_params is not None:
        model.load_state_dict(params_from_jax(init_params, cfg, model.tp, model.ep, model.pp))
    else:
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    model.train()
    parallel = model_axes(model)
    # The whole model's parameters (every rank's blocks and stages).
    whole = dict(llama_lib.Llama(cfg, device="meta").named_parameters())
    n_params = sum(p.numel() for p in whole.values())
    if mesh is not None:
        shard_model(model, mesh)
    log(
        f"[llama] {n_params / 1e6:.1f}M params, init +{time.time() - t_init:.1f}s"
        + (f", {local_nbytes(model.parameters()) / 2**20:.1f} MiB of them on rank {rank}"
           if world > 1 else "")
    )

    # The cosine horizon defaults to --max-steps, the global budget across
    # resumed lives (the restored count is global), else this life's length.
    opt = make_optimizer(
        model, lr, optimizer=optimizer, schedule=lr_schedule,
        warmup_steps=lr_warmup_steps,
        decay_steps=lr_decay_steps or max_steps or (steps + max(warmup, 1)),
        grad_clip=grad_clip, weight_decay=0.1, mesh=mesh,
    )
    aux_values = []  # one device scalar a loss_fn call
    rank_step = make_lm_train_step(model, opt, grad_accum=grad_accum, on_aux=aux_values.append,
                                   microbatches=pp_microbatches, pp_schedule=pp_schedule)

    def train_step(tokens):
        return world_mean(rank_step(tokens), world, mesh)

    def train_state():
        # Under tp, ep, sp or pp each tensor as the Block of its layout (its
        # offsets in the whole, written by one rank of its copies), which
        # the checkpoint writes and restores by.
        params = model_blocks(model) if parallel else model.state_dict()
        return {"params": params, "opt_state": opt.state_dict()}

    # A simulated preemption on the first life of this replica: die with a
    # retryable code (138 = 128 + SIGUSR1) so that the supervisor's
    # ExitCode policy restarts the gang and the next life resumes.
    restart_count = int(os.environ.get("TPUJOB_RESTART_COUNT", "0"))

    def maybe_preempt(step: int):
        if preempt_at is not None and restart_count == 0 and step >= preempt_at:
            log(f"[llama] injected preemption at step {step} (exit 138)")
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(138)

    # The elastic resize fence, polled each step: a rank the supervisor
    # moved to a resized world drains its loader, feed and pending saves,
    # then re-executes with the new world's coordinates (or exits, if
    # evicted); the fresh process resumes from the last verified step.
    train_world = rendezvous.world_from_env()

    def maybe_resize(step: int):
        sig = rendezvous.poll_resize(train_world)
        if sig is not None:
            resize_now(sig, step)

    def resize_now(sig, step: int):
        log(f"[llama] resize generation {sig.generation} observed at step {step}; draining")
        for drain in (prefetcher, loader, mgr):
            if drain is None:
                continue
            try:
                drain.close()
            except Exception:
                # invariant: waived — best-effort drain on resize; a broken loader must not block the exit
                pass
        rendezvous.exit_for_resize(sig)

    loader = None
    mgr = None
    prefetcher = None
    start_step = 0
    save_s = []
    # From here on, a failure (a corrupt checkpoint, a bad argument) must
    # not leak the native loader's prefetch thread and mapping, the feed's
    # threads, or a pending asynchronous save.
    try:
        if data_file:
            loader, _ = open_token_file(data_file, "--data-file", seed=0)
            log(f"[llama] data {data_file}: {loader.kind} loader")

            def host_batch(step: int):
                return host_tokens(loader)

        else:

            def host_batch(step: int):
                return synthetic_bigram_batch(batch_size, seq_len, cfg.vocab_size, step)

        ckpt_dir = job_checkpoint_dir()
        if checkpoint_every and ckpt_dir is not None:
            # The port's staged snapshot owns its bytes before save()
            # returns (async_writer.py), so it is safe beside the in-place
            # step; --donate is a no-op here.
            mgr = CheckpointManager(
                ckpt_dir, staged=async_checkpoint, process_id=rank, num_processes=world
            )
            # AdamW's state made now, so that a restore finds its layout
            # (sharded moments under FSDP).
            if hasattr(opt, "init_state"):
                opt.init_state()
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

        # The feed is built after the resume: its step counter starts where
        # the loop will, and the fast-forward above is done before a thread
        # pulls the loader.
        if prefetch > 0:
            feed_steps = itertools.count(start_step)
            prefetcher = DevicePrefetcher(
                lambda: data_lib.global_batch(
                    host_batch(next(feed_steps)), coords.data_index, coords.data_extent,
                    feed_microbatches,
                ),
                put=lambda toks: to_device(toks.astype(np.int64), dev),
                depth=prefetch,
                depth_max=prefetch_depth_max or None,
                workers=max(prefetch_workers, 1),
                autotune=feed_autotune,
            )

            def batches(step: int):
                maybe_preempt(step)
                maybe_resize(step)
                return prefetcher.get()

        else:

            def batches(step: int):
                maybe_preempt(step)
                maybe_resize(step)
                return data_lib.put_global(
                    host_batch(step), dev, coords.data_index, coords.data_extent, feed_microbatches
                ).long()

        def save(step: int):
            t0 = time.perf_counter()
            mgr.save(step, train_state(), block=not async_checkpoint)
            save_s.append(time.perf_counter() - t0)

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        counts = {"run": flash_lib.launch_counts(), "tp_gathers": ulysses_lib.tp_gather_count}

        def on_first():
            rendezvous.report_first_step(start_step)
            counts["start"] = flash_lib.launch_counts()

        tokens_per_step = batch_size * seq_len
        try:
            losses, steps_per_sec, end_step = throughput_loop(
                train_step, batches, steps=steps, warmup=warmup, on_first_step=on_first,
                checkpoint_every=checkpoint_every,
                save=save if mgr is not None else None,
                start_step=start_step,
                log=lambda m: log(f"[llama] {m}"),
                profile_dir=profile_dir,
                progress=(
                    heartbeat_reporter(
                        rendezvous.report_progress, batch=tokens_per_step, n_dev=world,
                        unit="tokens/sec/chip", feed=prefetcher,
                    )
                    if rendezvous.progress_enabled()
                    else None
                ),
            )
        except RuntimeError as err:
            # A collective that lost a peer (a preempted rank): gloo raises
            # at once, before the supervisor has committed the resize that
            # a death the gang absorbs brings, so wait for its record.
            if world > 1 and rendezvous.peer_lost(err):
                log(f"[llama] a peer went away ({str(err).splitlines()[0][:120]}); waiting for a resize")
                sig = rendezvous.await_resize(train_world)
                if sig is not None:
                    resize_now(sig, -1)
            raise
        done = flash_lib.launch_counts()
        if mgr is not None and mgr.latest_step() != end_step:
            mgr.save(end_step, train_state())
    finally:
        if prefetcher is not None:
            prefetcher.close()
        if loader is not None:
            loader.close()
        if mgr is not None:
            mgr.close()  # commits the pending asynchronous saves
    kept = full_state_dict(model) if keep_params else None
    steps_after_first = end_step - start_step - 1
    per_step = {
        k: (done[k] - counts["start"][k]) // max(steps_after_first, 1) for k in done
    }
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    losses = [float(x) for x in losses]
    final_loss = losses[-1]
    tokens_per_sec = steps_per_sec * tokens_per_step
    rendezvous.report_metrics(
        end_step, tokens_per_sec=tokens_per_sec, tokens_per_sec_per_chip=tokens_per_sec / world,
        final_loss=final_loss,
    )
    log(
        f"[llama] {steps} steps: {tokens_per_sec:,.0f} tokens/sec "
        f"({1000 / steps_per_sec if steps_per_sec else float('nan'):.1f} ms/step), "
        f"final loss {final_loss:.3f}"
        + (f", peak memory {peak / 2**30:.2f} GiB" if peak is not None else "")
    )
    mine = {
        "rank": rank,
        "data_index": coords.data_index,
        "tp_index": coords.tp_index,
        "sp_index": coords.sp_index,
        "ep_index": coords.ep_index,
        "pp_index": coords.pp_index,
        "expert_param_bytes": local_nbytes(
            p for n, p in model.named_parameters() if n.endswith(("moe_mlp.w_in", "moe_mlp.w_out"))
        ),
        "param_bytes": local_nbytes(model.parameters()),
        "optimizer_state_bytes": opt.state_nbytes(),
        "peak_mem_bytes": peak,
        "flash_launches": {k: done[k] - counts["run"][k] for k in done},
        "tp_head_gathers": ulysses_lib.tp_gather_count - counts["tp_gathers"],
    }
    per_rank = [mine]
    if world > 1:
        per_rank = [None] * world
        torch.distributed.all_gather_object(per_rank, mine)
    result = {
        "metric": "llama_train_tokens_per_sec_per_chip",
        "value": round(tokens_per_sec / world, 1),
        "unit": "tokens/sec/chip",
        "config": config,
        "params_m": round(n_params / 1e6, 1),
        "final_loss": round(final_loss, 4),
        "end_step": end_step,
        "devices": world,
        "n_layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "step_s": 1.0 / steps_per_sec if steps_per_sec else None,
        "losses": losses,
        "peak_mem_bytes": peak,
        "flash_launches_per_step": per_step,
        "optimizer": optimizer,
        "optimizer_state_bytes": mine["optimizer_state_bytes"],
        "param_bytes": mine["param_bytes"],
        "world": world,
        "mesh": axes,
        "backend": backend,
        "per_rank": per_rank,
        "device": device_name(dev),
    }
    if loader is not None:
        result["loader"] = loader.kind
    if prefetcher is not None:
        result["feed"] = prefetcher.stats()
    if save_s:
        result["save_s"] = save_s
    if kept is not None:
        result["params"] = kept
    if donate is not None:
        result["donate"] = "no-op (torch has no buffer donation)"
    if pp > 1:
        result["pp_schedule"] = pp_schedule
        result["pp_microbatches"] = pp_microbatches
    if cfg.n_experts > 1:
        # FLOPs-active parameters: sparse dispatch computes about top_k/E of
        # the expert banks a token (capacity padding excluded), dense all.
        expert = sum(p.numel() for n, p in whole.items() if n.endswith(("moe_mlp.w_in", "moe_mlp.w_out")))
        frac = cfg.moe_top_k / cfg.n_experts if cfg.moe_dispatch == "sparse" else 1.0
        result["n_experts"] = cfg.n_experts
        result["moe_dispatch"] = cfg.moe_dispatch
        result["active_params_m"] = round((n_params - expert + expert * frac) / 1e6, 1)
    if aux_values:
        result["aux_losses"] = torch.stack(aux_values).view(-1, grad_accum).mean(1).tolist()

    if eval_file:
        # Held-out loss: the training objective, a fixed batch order, no
        # updates.
        eval_loader, eval_meta = open_token_file(eval_file, "--eval-file", seed=1)
        try:
            eval_step = make_lm_eval_step(model, microbatches=pp_microbatches)
            n_eval = max(1, min(eval_batches, eval_meta.n_records // batch_size))
            eval_losses = [
                float(world_mean(eval_step(next_tokens(eval_loader)), world, mesh))
                for _ in range(n_eval)
            ]
        finally:
            eval_loader.close()
        eval_loss = sum(eval_losses) / len(eval_losses)
        ppl = math.exp(min(eval_loss, 30.0))
        rendezvous.report_metrics(end_step, eval_loss=eval_loss, eval_perplexity=ppl)
        log(f"[llama] eval: loss {eval_loss:.4f} (ppl {ppl:.1f}) over {n_eval} held-out batch(es)")
        result["eval_loss"] = round(eval_loss, 4)
        result["eval_perplexity"] = round(ppl, 2)
    return result


def _preempt_at(args):
    """``--preempt-at``, or None when ``--preempt-index`` is given and this
    replica's ``TPUJOB_REPLICA_INDEX`` is not in its comma-separated list."""
    if args.preempt_index is None:
        return args.preempt_at
    chosen = {int(s) for s in str(args.preempt_index).split(",") if s.strip()}
    return args.preempt_at if int(os.environ.get("TPUJOB_REPLICA_INDEX", "0")) in chosen else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", choices=sorted(CONFIGS), default="tiny")
    p.add_argument(
        "--mesh", default=None,
        help='axes over the world\'s ranks, e.g. "fsdp=2", "dp=2", "tp=2", "fsdp=2,tp=2", '
        '"sp=2", "dp=2,ep=2", "pp=2", "dp=2,pp=2", "pp=2,tp=2", "pp=2,ep=2", "dp=2@dcn,fsdp=-1" '
        '(default: TPUJOB_MESH or fsdp=-1)',
    )
    p.add_argument("--batch-size", type=int, default=8, help="the global batch, over every rank")
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
        help="adafactor: factored second moments — optimizer state ~N/k floats "
        "instead of AdamW's 2N",
    )
    p.add_argument(
        "--grad-accum", type=int, default=1,
        help="split the batch into N sequential microbatches (gradients "
        "summed in f32, one optimizer update)",
    )
    p.add_argument(
        "--attn-impl", choices=("dense", "flash", "ring", "ulysses"), default=None,
        help="attention implementation (flash = the CUDA kernels); ring = "
        "sequence-parallel K/V rotation over sp; ulysses = all-to-all head/seq "
        "swap over sp (both dense f32 over the whole sequence without sp)",
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
    p.add_argument(
        "--async-checkpoint", action="store_true",
        help="commit checkpoints off the step loop: save() issues the copies to host "
        "and returns; the write and its checksum sidecar land on a background "
        "thread, verified. Committed by the run's end; a preemption may lose the "
        "in-flight save and resume one interval earlier. Default: spec.data_plane / "
        "TPUJOB_ASYNC_CHECKPOINT",
    )
    p.add_argument(
        "--prefetch", type=int, default=None, metavar="DEPTH",
        help="device feed: keep DEPTH batches on the card ahead of the step loop "
        "(host work and host-to-device copy on feed threads; 0 = inline). Default: "
        "spec.data_plane / TPUJOB_PREFETCH",
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
    p.add_argument(
        "--experts", type=int, default=None, dest="n_experts",
        help="mixture-of-experts MLP with this many experts, sharded over the mesh's "
        "ep axis (all on each rank without one)",
    )
    p.add_argument(
        "--moe-top-k", type=int, default=None, dest="moe_top_k",
        help="experts routed per token (default 2); must be <= --experts",
    )
    p.add_argument(
        "--moe-dispatch", choices=("dense", "sparse"), default=None, dest="moe_dispatch",
        help="expert dispatch: dense (exact, FLOPs scale with experts) or sparse "
        "(capacity-factor: FLOPs scale with top-k, over-capacity tokens dropped)",
    )
    p.add_argument(
        "--moe-capacity-factor", type=float, default=None, dest="moe_capacity_factor",
        help="sparse dispatch per-expert capacity multiplier (default 1.25); higher "
        "drops fewer tokens, costs more FLOPs",
    )
    p.add_argument(
        "--moe-aux-weight", type=float, default=None, dest="moe_aux_weight",
        help="weight of the Switch-Transformer load-balance loss (typical 1e-2; "
        "default 0 = off); spreads the router across experts",
    )
    p.add_argument(
        "--preempt-at", type=int, default=None,
        help="fault injection: die with the retryable exit code 138 at this step "
        "on the replica's first life (a simulated preemption)",
    )
    p.add_argument(
        "--preempt-index", default=None,
        help="restrict --preempt-at to the replicas whose TPUJOB_REPLICA_INDEX is in "
        "this comma-separated list",
    )
    p.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler trace of the timed window here (read it with "
        "python -m pytorch_operator_tpu_torch.profiling)",
    )
    p.add_argument("--seed", type=int, default=0, help="seed of the random init")
    p.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; TPUJOB_PLATFORM=cpu also selects the CPU",
    )
    p.add_argument("--json", action="store_true")
    p.add_argument(
        "--pp-microbatches", type=int, default=None,
        help="pipeline microbatches of the global batch when the mesh has a pp axis "
        "(default 2 x pp extent; must be a multiple of it)",
    )
    p.add_argument(
        "--pp-schedule", choices=("gpipe", "1f1b"), default="gpipe",
        help="pipeline schedule on a pp mesh: gpipe (every microbatch's graph kept, then the "
        "reverse ticks) or 1f1b (one forward one backward: a stage holds at most 2(pp-1)+1 "
        "microbatches)",
    )
    add_feed_tuning_args(p)
    args = p.parse_args(argv)

    env_async, env_prefetch = data_plane_env_defaults()
    feed_tuning = resolve_feed_tuning(args)
    world = rendezvous.initialize_from_env(device=args.device)
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
        async_checkpoint=args.async_checkpoint or env_async,
        prefetch=args.prefetch if args.prefetch is not None else env_prefetch,
        prefetch_depth_max=feed_tuning["prefetch_depth_max"],
        feed_autotune=feed_tuning["autotune"],
        prefetch_workers=feed_tuning["prefetch_workers"],
        max_steps=args.max_steps,
        remat=True if args.remat else None,
        remat_policy=args.remat_policy,
        donate=args.donate,
        grad_accum=args.grad_accum,
        n_layers=args.n_layers,
        param_dtype=args.param_dtype,
        n_experts=args.n_experts,
        moe_top_k=args.moe_top_k,
        moe_dispatch=args.moe_dispatch,
        moe_capacity_factor=args.moe_capacity_factor,
        moe_aux_weight=args.moe_aux_weight,
        attn_impl=args.attn_impl,
        xent_impl=args.xent_impl,
        preempt_at=_preempt_at(args),
        profile_dir=args.profile_dir,
        mesh_spec=args.mesh,
        pp_microbatches=args.pp_microbatches,
        pp_schedule=args.pp_schedule,
        device=args.device,
        seed=args.seed,
        log=lambda msg: print(
            f"[rank {world.process_id}/{world.num_processes}] {msg}"
            if world.num_processes > 1 else msg,
            flush=True,
        ),
    )
    if args.json and world.process_id == 0:
        print(json.dumps(result), flush=True)
    # A multi-process world leaves through finalize (never returns): no gloo
    # or NCCL thread may race the teardown of a replica that is done.
    rendezvous.finalize(world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
