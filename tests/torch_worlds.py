"""Multi-process worlds of the PyTorch port for the tests, on the CPU: each
rank a process spawned with ``torch.multiprocessing``, given the env the
supervisor injects (``TPUJOB_*``, ``MASTER_*``, ``WORLD_SIZE``, ``RANK``,
``TPUJOB_PLATFORM=cpu``), joined by the port's
``rendezvous.initialize_from_env`` over gloo. A rank runs one of the
``rank_*`` functions below (torch and the port only: no jax in a rank) and
its return value comes back through a file.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np


def _share_the_host() -> None:
    """Under pytest-xdist, give each worker's torch an equal share of the
    host's cores. Every worker imports this module while it collects, before
    any test runs. torch's default intra-op pool, one thread a core in every
    worker, oversubscribes the host many times over, and a test of many
    small ops then runs tens of times slower than alone."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


_share_the_host()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_env(rank: int, n: int, port: int, **extra) -> dict:
    """The supervisor's cluster env for rank ``rank`` of ``n`` (Master is
    rank 0, Worker i rank i+1), on the CPU."""
    env = {
        "TPUJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "TPUJOB_NUM_PROCESSES": str(n),
        "TPUJOB_PROCESS_ID": str(rank),
        "TPUJOB_REPLICA_TYPE": "Master" if rank == 0 else "Worker",
        "TPUJOB_REPLICA_INDEX": str(0 if rank == 0 else rank - 1),
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port),
        "WORLD_SIZE": str(n),
        "RANK": str(rank),
        "TPUJOB_PLATFORM": "cpu",
    }
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _entry(rank, n, port, fn_name, args, out_dir, extra_env, timeout):
    import faulthandler

    # A rank still running near the timeout prints every thread's stack.
    faulthandler.dump_traceback_later(max(timeout - 10, 1), exit=False)
    os.environ.update(world_env(rank, n, port, **extra_env))
    out = Path(out_dir) / f"r{rank}.pkl"
    try:
        import torch

        torch.set_num_threads(1)
        from pytorch_operator_tpu_torch.runtime import rendezvous

        world = rendezvous.initialize_from_env(timeout_s=60)
        result = globals()[fn_name](world, *args)
        payload = {"ok": True, "result": result}
    except BaseException:  # noqa: BLE001 — reported to the test
        payload = {"ok": False, "error": traceback.format_exc()}
    out.write_bytes(pickle.dumps(payload))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def run_world(fn_name: str, *args, n: int = 2, timeout: float = 180.0, **extra_env) -> list:
    """Run ``rank_<fn_name>(world, *args)`` on every rank of a fresh
    ``n``-process world; the ranks' return values, in rank order. A rank
    that raises, dies or outlives ``timeout`` fails the call."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="torch_world_") as out_dir:
        procs = [
            ctx.Process(target=_entry, args=(r, n, port, f"rank_{fn_name}", args, out_dir, extra_env, timeout))
            for r in range(n)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        payloads = []
        for r in range(n):
            path = Path(out_dir) / f"r{r}.pkl"
            payloads.append(pickle.loads(path.read_bytes()) if path.exists() else None)
        errors = [
            f"rank {r}: " + ("left no result" if pl is None else pl["error"])
            for r, pl in enumerate(payloads) if pl is None or not pl["ok"]
        ]
        if errors:
            raise RuntimeError(
                f"world failed (exit codes {[p.exitcode for p in procs]}, {len(alive)} killed at "
                f"the timeout):\n" + "\n".join(errors)
            )
        results = [pl["result"] for pl in payloads]
    return results


# ---- what a rank runs ----


def planted(name):
    """A context in which the planted fault ``name`` replaces the port's
    code (None: no fault):

    - ``"leave_psum_autograd"``: tp's leave written with ``psum_autograd``,
      whose backward sums too (every gradient upstream multiplied by tp);
    - ``"unshifted_vocab_sum"``: the vocab-parallel loss summing the ranks'
      ``s`` without the shift by ``exp(m - M)``;
    - ``"unreduced_rows"``: adafactor's row statistics (the means over a
      factored leaf's largest dim) left unreduced over the axes that split
      that dim;
    - ``"pp_shifted_cotangent"``: each pipeline stage backwarding a
      microbatch's stored graph with the previous microbatch's cotangent
      (the first with its own);
    - ``"ulysses_sp_heads"``: ulysses under tp keeping, of the global heads'
      output, the block at the rank's sp coordinate instead of its tp
      coordinate;
    - ``"pp_tp_outer_head"``: ``params_from_jax`` taking each rank's
      blocks with the axes nested the other way (tp outer, pp inner: the
      head's rows of stage s, tp rank t at ``t·V/tp + s·V/(tp·P)``), while
      the loss's column offset stays pp-outer;
    - ``"bert_bias_every_rank"``: BERT's row-parallel products (o_proj,
      ``mlp_down``) adding the whole bias on every tp rank before the sum;
    - ``"bert_pos_embed_by_suffix"``: BERT's parameter axes looked up by
      the Llama's suffixes for the embeddings, so that ``pos_embed`` (which
      ends with ``embed.weight``) is split over tp like a vocabulary;
    - ``"pp_coordinate_rows"``: the feed giving each data coordinate its own
      consecutive rows of the global batch whatever its microbatches (the
      pipeline's microbatches then split those rows, not JAX's global
      batch)."""
    import contextlib

    @contextlib.contextmanager
    def patch():
        if name is None:
            yield
            return
        import torch

        from pytorch_operator_tpu_torch.ops import chunked_xent
        from pytorch_operator_tpu_torch.parallel import collectives
        from pytorch_operator_tpu_torch.workloads import trainer

        if name == "leave_psum_autograd":
            where, attr = collectives, "tp_leave"
            fault = lambda x, axis="tp", mesh=None: collectives.psum_autograd(x, axis, mesh)  # noqa: E731
        elif name == "unshifted_vocab_sum":
            where, attr = chunked_xent, "combine_vocab_stats"

            def fault(m, s, lab_logit, tp):
                M = collectives.pmax(m, "tp", tp.mesh)
                lse = M + torch.log(collectives.psum(s, "tp", tp.mesh))
                return lse, lse - collectives.psum(lab_logit, "tp", tp.mesh)
        elif name == "pp_shifted_cotangent":
            from pytorch_operator_tpu_torch.parallel import pipeline

            where, attr = pipeline._Stage, "backward"
            sound_backward = pipeline._Stage.backward

            def fault(self, j, cot):
                prev, self.prev_cot = getattr(self, "prev_cot", None), cot
                return sound_backward(self, j, cot if prev is None else prev)
        elif name == "ulysses_sp_heads":
            from pytorch_operator_tpu_torch.parallel import ulysses

            where, attr = ulysses, "own_heads"

            def fault(out, n, axis, mesh):
                return out.narrow(2, collectives.axis_index("sp", mesh) * n, n)
        elif name == "unreduced_rows":
            where, attr = trainer.Adafactor, "_mean"
            sound = trainer.Adafactor._mean

            def fault(self, x, dims, lay, leaf_dims, keepdim=False):
                factored = trainer._factored_dims(lay.whole)
                if factored is not None and list(leaf_dims) == [factored[1]] and not keepdim:
                    return x.mean(dims)
                return sound(self, x, dims, lay, leaf_dims, keepdim)
        elif name == "pp_tp_outer_head":
            from pytorch_operator_tpu_torch.parallel import sharding

            where, attr = sharding, "take_block"  # as params_from_jax reads it

            def fault(t, splits):
                for ax, d in sharding.cut_splits(splits):
                    t = t.narrow(d, *ax.block(t.shape[d], "a planted block"))
                return t
        elif name == "bert_bias_every_rank":
            import torch.nn.functional as F

            from pytorch_operator_tpu_torch.models import bert

            where, attr = bert, "row_parallel"

            def fault(dense, x, tp):
                dt = dense.compute_dtype
                return dense(x) if tp is None else tp.leave(
                    F.linear(x.to(dt), dense.weight.to(dt), dense.bias.to(dt)))
        elif name == "bert_pos_embed_by_suffix":
            from pytorch_operator_tpu_torch.parallel import sharding

            where, attr = sharding, "param_axes"
            sound_axes = sharding.param_axes

            def fault(name, table=sharding.LLAMA_PARAM_AXES):
                if table is sharding.BERT_PARAM_AXES and name.endswith("embed.weight"):
                    return sound_axes(name)  # the Llama's embed.weight
                return sound_axes(name, table)
        elif name == "pp_coordinate_rows":
            from pytorch_operator_tpu_torch.parallel import data

            where, attr = data, "global_batch"
            sound_rows = data.global_batch

            def fault(batch, process_index=None, process_count=None, microbatches=1):
                return sound_rows(batch, process_index, process_count)
        else:
            raise ValueError(f"no planted fault {name!r}")
        saved = getattr(where, attr)
        setattr(where, attr, fault)
        try:
            yield
        finally:
            setattr(where, attr, saved)

    return patch()


def rank_train(world, runs: list) -> list:
    """``llama_train.run(device="cpu", **kw)`` for each ``kw`` of ``runs``
    in this world (``kw["env"]``, if given, is set in the environment
    first; ``kw["plant"]`` names a :func:`planted` fault to run it under);
    each run's result, with ``params``: the whole trained parameters
    (gathered from the shards and tp's blocks) as numpy arrays. A run with
    ``kw["raises"]`` must raise that exception type: its message is the
    result."""
    from pytorch_operator_tpu_torch.workloads import llama_train

    out = []
    for kw in runs:
        kw = dict(kw)
        os.environ.update(kw.pop("env", {}))
        raises = kw.pop("raises", None)
        plant = kw.pop("plant", None)
        if raises is not None:
            try:
                llama_train.run(device="cpu", log=lambda m: None, **kw)
            except raises as e:
                out.append(str(e))
                continue
            raise AssertionError(f"run({kw}) did not raise {raises.__name__}")
        with planted(plant):
            r = llama_train.run(device="cpu", log=lambda m: None, keep_params=True, **kw)
        # bf16 parameters come back as f32 arrays (numpy has no bf16).
        r["params"] = {name: t.float().numpy() for name, t in r["params"].items()}
        out.append(r)
    return out


def rank_collectives(world, shapes) -> dict:
    """Each collective of ``parallel/collectives.py`` on this rank's
    values (rank r's tensor is ``arange(size) + 100·r``), over the world's
    ``dp`` axis and over the ``fsdp`` axis of a (dp=1, fsdp=n) mesh; and the
    layouts of the hybrid and default meshes."""
    import torch

    from pytorch_operator_tpu_torch.parallel import collectives as c
    from pytorch_operator_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh, mesh_from_env

    n, r = world.num_processes, world.process_id
    out = {"layouts": {
        name: (m.mesh_dim_names, tuple(m.mesh.shape))
        for name, m in (("hybrid", make_hybrid_mesh("fsdp=-1", "dp=2", "cpu")),
                        ("hybrid_spec", make_mesh("dp=2@dcn,fsdp=-1", "cpu")),
                        ("env_default", mesh_from_env(device_type="cpu")))
    }}
    for name, spec, axis in (("dp", {"dp": n}, "dp"), ("fsdp", "dp=1,fsdp=-1", "fsdp")):
        mesh = make_mesh(spec, "cpu")
        for shape in shapes:
            x = torch.arange(float(np.prod(shape))).reshape(shape) + 100 * r
            got = {
                "psum": c.psum(x, axis, mesh),
                "pmean": c.pmean(x, axis, mesh),
                "all_gather": c.all_gather(x, axis, mesh),
                "all_gather_stacked": c.all_gather(x, axis, mesh, tiled=False),
                "reduce_scatter": c.reduce_scatter(x, axis, mesh),
                "reduce_scatter_dim1": c.reduce_scatter(x, axis, mesh, scatter_dimension=1),
                "ring_shift": c.ring_shift(x, axis, mesh, shift=1),
                "ring_shift_back": c.ring_shift(x, axis, mesh, shift=-1),
            }
            assert torch.equal(x, torch.arange(float(np.prod(shape))).reshape(shape) + 100 * r)
            out[(name, shape)] = {k: v.numpy() for k, v in got.items()}
            out[(name, shape)]["index"] = (c.axis_index(axis, mesh), c.axis_size(axis, mesh))
        # sharding.full_tensor of FSDP2's dim-0 layout, rows even and not.
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        from pytorch_operator_tpu_torch.parallel.sharding import full_tensor

        placements = [Shard(0)] if name == "dp" else [Replicate(), Shard(0)]
        for rows in (4, 5, 1):
            whole = torch.arange(rows * 3.0).view(rows, 3)
            out[(name, "full", rows)] = full_tensor(distribute_tensor(whole, mesh, placements)).numpy()
    return out


def rank_restore_own_rows(world, root: str, step: int) -> dict:
    """Restore ``params`` of a two-rank ``fsdp=2`` step of the tiny model
    into this rank's ``fsdp=2`` layout, with every record of another
    rank's file replaced by a meta tensor (which holds no data: copying out
    of one raises). So the restore succeeds only if it reads no row of
    another rank's file. Returns this rank's rows (name: (offset, array))
    and whether a whole-tensor restore under the same files raised."""
    import torch
    from torch.distributed.tensor import DTensor

    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, manager
    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.sharding import dim0_rows, shard_model

    def blind(tree):
        if isinstance(tree, dict) and manager.SHARD in tree:
            local = tree[manager.SHARD]
            return {**tree, manager.SHARD: None if local is None else torch.empty_like(local, device="meta")}
        if isinstance(tree, dict):
            return {k: blind(v) for k, v in tree.items()}
        return tree

    real_load = torch.load
    mine = f".r{world.process_id}.pt"

    def load(path, *a, **kw):
        tree = real_load(path, *a, **kw)
        return tree if str(path).endswith(mine) else blind(tree)

    model = llama_lib.Llama(llama_lib.llama_tiny(), device="cpu")
    shard_model(model, make_mesh("fsdp=2", "cpu"))
    mgr = CheckpointManager(root, process_id=world.process_id, num_processes=world.num_processes)
    torch.load = load
    try:
        got = mgr.restore({"params": model.state_dict()}, step=step)["params"]
        try:
            mgr.restore({"params": None}, step=step)
            whole_raised = False
        except (NotImplementedError, RuntimeError):
            whole_raised = True
    finally:
        torch.load = real_load
    out = {}
    for name, t in got.items():
        assert isinstance(t, DTensor), name
        offset, _ = dim0_rows(t.shape, t.device_mesh, t.placements)
        out[name] = (offset, t.to_local().numpy().copy())
    return {"rows": out, "whole_raised": whole_raised}


def rank_resnet(world, init: dict, x, y, steps: int, sync_stats: bool, bench_kw=None) -> dict:
    """A tiny f32 ResNet (stage sizes [1, 1], 8 filters, 10 classes) from the
    state dict ``init``, ``steps`` SGD-nesterov steps of
    ``resnet_bench.make_train_step`` on this rank's rows of the global batch
    ``x``/``y``, batch norm synchronised across the ranks unless
    ``sync_stats`` is False (the planted per-rank fault); the losses and the
    final state dict. With ``bench_kw``, also ``resnet_bench.run_benchmark``'s
    result in this world."""
    import torch

    from pytorch_operator_tpu_torch.models import resnet
    from pytorch_operator_tpu_torch.workloads import resnet_bench

    model = resnet.ResNet([1, 1], num_classes=10, num_filters=8, dtype=torch.float32,
                          sync_stats=sync_stats)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    step, _ = resnet_bench.make_train_step(model, lr=0.1, momentum=0.9, world=world.num_processes)
    per = x.shape[0] // world.num_processes
    rows = slice(world.process_id * per, (world.process_id + 1) * per)
    bx, by = torch.from_numpy(x[rows]), torch.from_numpy(y[rows]).long()
    losses = [float(step(bx, by)) for _ in range(steps)]
    out = {"losses": losses, "state": {k: v.numpy().copy() for k, v in model.state_dict().items()}}
    if bench_kw is not None:
        out["bench"] = resnet_bench.run_benchmark(device="cpu", log=lambda m: None, **bench_kw)
    return out


def rank_entry_devices(world, eval_file: str, spool_root: str) -> dict:
    """(a) With two cards faked (``torch.cuda.is_available`` True,
    ``device_count`` 2) and no ``TPUJOB_PLATFORM``, the device that
    ``generate.run``, ``serve.run`` and ``quality_eval.run`` each resolve
    (each stopped at its ``load_params``, before anything touches a card);
    (b) ``serve.run`` on the CPU over this rank's own spool (two requests):
    its stats."""
    import torch

    from pytorch_operator_tpu_torch.serving import Spool
    from pytorch_operator_tpu_torch.workloads import generate, quality_eval, serve

    seen = {}

    class Stop(Exception):
        pass

    def stop_at(tag):
        def load_params(cfg, *, device, **kw):
            seen[tag] = str(device)
            raise Stop

        return load_params

    saved = dict(avail=torch.cuda.is_available, count=torch.cuda.device_count,
                 gen=generate.load_params, qe=quality_eval.load_params,
                 names=[m.device_name for m in (generate, serve, quality_eval)],
                 platform=os.environ.pop("TPUJOB_PLATFORM"))
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 2
    for m in (generate, serve, quality_eval):
        m.device_name = str
    quiet = dict(log=lambda m: None)
    calls = {
        "generate": lambda: generate.run(config="tiny", **quiet),
        "serve": lambda: serve.run(config="tiny", spool_dir=f"{spool_root}/faked{world.process_id}", **quiet),
        "quality_eval": lambda: quality_eval.run(restore="unused", eval_file=eval_file, batch_size=2,
                                                 eval_batches=1, **quiet),
    }
    try:
        for tag, call in calls.items():
            generate.load_params = quality_eval.load_params = stop_at(tag)
            try:
                call()
            except Stop:
                pass
    finally:
        torch.cuda.is_available, torch.cuda.device_count = saved["avail"], saved["count"]
        generate.load_params, quality_eval.load_params = saved["gen"], saved["qe"]
        for m, name in zip((generate, serve, quality_eval), saved["names"]):
            m.device_name = name
        os.environ["TPUJOB_PLATFORM"] = saved["platform"]
    spool = f"{spool_root}/r{world.process_id}"
    sp = Spool(spool)
    for _ in range(2):
        sp.submit(prompt_len=5, max_new_tokens=4)
    stats = serve.run(config="tiny", spool_dir=spool, slots=2, chunk=8, block=4, max_decode_len=48,
                      max_requests=2, idle_timeout=60, device="cpu", **quiet)
    return {"seen": seen, "serve": stats}


def _blocks_out(tree):
    """``tree`` with each ``sharding.Block`` (and each DTensor, as its
    block) as a dict of its offsets, whole shape, writer flag and data
    (numpy, f32 for bf16), for the test process to assemble the whole from
    the ranks' parts."""
    from torch.distributed.tensor import DTensor

    from pytorch_operator_tpu_torch.parallel.sharding import Block, Elsewhere

    if isinstance(tree, DTensor):
        tree = Block.of(tree)
    if isinstance(tree, Block):
        return {"offsets": tuple(tree.offsets), "shape": tuple(tree.shape), "writer": tree.writer,
                "data": tree.data.detach().float().numpy().copy()}
    if isinstance(tree, dict):  # another pp stage's tensors left out
        return {k: _blocks_out(v) for k, v in tree.items() if not isinstance(v, Elsewhere)}
    return tree


def rank_adafactor(world, runs: list) -> list:
    """For each run (``mesh``, the Llama config's overrides ``cfg``, the
    JAX init ``tree``, token ``batches``, ``lr``, optional ``plant`` and
    ``teacher``): the port's adafactor under that mesh, built by hand as
    ``llama_train`` builds it (tp's blocks, FSDP2 over the data axes, the
    statistics reduced over the mesh). Free-running, one step a batch; with
    ``teacher`` (one ``(tree, opt_state)`` a step, JAX's before that step)
    each step starts again from JAX's parameters and state. Returns each
    step's loss, the gathered parameters after every step and the last
    statistics as blocks."""
    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.models.convert import params_from_jax
    from pytorch_operator_tpu_torch.parallel.data import put_global
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh, train_coords
    from pytorch_operator_tpu_torch.parallel.sharding import TensorParallel, full_state_dict, shard_model
    from pytorch_operator_tpu_torch.workloads import trainer

    out = []
    for run in runs:
        mesh = make_mesh(run["mesh"], "cpu")
        tp, coords = TensorParallel.of(mesh), train_coords(mesh)
        cfg = llama_lib.llama_tiny(**run["cfg"])

        def build(tree, opt_state=None):
            model = llama_lib.Llama(cfg, tp=tp)
            model.load_state_dict(params_from_jax(tree, cfg, tp))
            shard_model(model, mesh)
            opt = trainer.make_optimizer(model, run["lr"], optimizer="adafactor", mesh=mesh)
            if opt_state is not None:
                opt.load_state_dict(opt_state)
            return model, opt

        teacher = run.get("teacher")
        model, opt = build(*(teacher[0] if teacher else (run["tree"],)))
        losses, params = [], []
        with planted(run.get("plant")):
            for i, toks in enumerate(run["batches"]):
                if teacher and i:
                    model, opt = build(*teacher[i])
                step = trainer.make_lm_train_step(model, opt)
                rows = put_global(toks, "cpu", coords.data_index, coords.data_extent).long()
                losses.append(float(trainer.world_mean(step(rows), world.num_processes, mesh)))
                params.append({k: v.float().numpy() for k, v in full_state_dict(model).items()})
        out.append({"losses": losses, "params": params, "state": _blocks_out(opt.state_dict()),
                    "state_nbytes": opt.state_nbytes()})
    return out


def rank_vocab_parallel(world, h, w, labels, ct, chunk: int, plants: list) -> dict:
    """``ops.chunked_xent.vocab_parallel_xent`` on a ``tp`` mesh of the
    world: this rank's block of ``w``'s columns, the whole ``h`` and
    ``labels``, backward with the cotangent ``ct``; under each of
    ``plants`` (a :func:`planted` fault or None). Returns, by plant, the
    per-token loss, h's gradient (summed over tp by ``tp_enter``) and this
    rank's block's gradient with its first column."""
    import torch

    from pytorch_operator_tpu_torch.ops.chunked_xent import vocab_parallel_xent
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.sharding import TensorParallel

    tp = TensorParallel.of(make_mesh({"tp": world.num_processes}, "cpu"))
    start, n = tp.block(w.shape[1], "vocab")
    out = {}
    for plant in plants:
        hh = torch.tensor(h, requires_grad=True)
        ww = torch.tensor(w[:, start:start + n], requires_grad=True)
        with planted(plant):
            loss = vocab_parallel_xent(hh, ww, torch.tensor(labels), tp=tp, col_offset=start, chunk=chunk)
            loss.backward(torch.tensor(ct))
        out[plant] = {"loss": loss.detach().numpy(), "dh": hh.grad.numpy(), "dw": ww.grad.numpy(),
                      "start": start}
    return out


def rank_pp_model(world, tree, cfg_over: dict, mesh_spec: str, tokens, steps: int, schedule: str) -> dict:
    """The tiny Llama at 4 layers (``cfg_over``, dense attention) on this
    world's ``mesh_spec`` built by hand as ``tests/test_llama_pp.py``'s
    ``_train`` builds JAX's: JAX's ``tree`` carried by ``params_from_jax``,
    optax's ``adamw(1e-3)`` (weight decay 1e-4), ``steps`` steps of
    ``schedule`` on the same ``tokens`` [B, S] (this data coordinate's
    rows). Returns each step's loss, the first step's gradients whole
    (gathered from every rank's blocks before the update, by name), this
    rank's coordinates and its head rows as loaded (``[D, rows]``, JAX's
    layout) with their first id."""
    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.models.convert import params_from_jax
    from pytorch_operator_tpu_torch.parallel.data import put_global
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh, train_coords
    from pytorch_operator_tpu_torch.parallel.sharding import shard_model
    from pytorch_operator_tpu_torch.workloads import trainer

    mesh = make_mesh(mesh_spec, "cpu")
    coords = train_coords(mesh)
    cfg = llama_lib.llama_tiny(n_layers=4, attn_impl="dense", **cfg_over)
    model = llama_lib.Llama(cfg, mesh=mesh)
    model.load_state_dict(params_from_jax(tree, cfg, model.tp, model.ep, model.pp))
    head = model.head_kernel().detach().numpy().copy()
    shard_model(model, mesh)
    opt = trainer.make_optimizer(model, 1e-3, weight_decay=1e-4)
    grads = first_step_grads(model, opt, lambda: _whole_pp_grads(model))
    step = trainer.make_lm_train_step(model, opt, pp_schedule=schedule)
    rows = put_global(np.asarray(tokens), "cpu", coords.data_index, coords.data_extent).long()
    losses = [float(trainer.world_mean(step(rows), world.num_processes, mesh)) for _ in range(steps)]
    return {"losses": losses, "grads": grads, "pp_index": coords.pp_index, "tp_index": coords.tp_index,
            "head": head, "head_offset": model.vocab_offset}


def first_step_grads(model, opt, whole) -> dict:
    """A dict that ``opt``'s first ``step()`` fills, before its update, with
    ``whole()``: the gradients by name as numpy arrays."""
    grads, update = {}, opt.step

    def step():
        if not grads:
            grads.update({n: g.float().numpy() for n, g in whole().items()})
        update()

    opt.step = step
    return grads


def _whole_pp_grads(model) -> dict:
    """Each parameter's gradient of a pp model whole on every rank, by
    name: tp's blocks and pp's head rows gathered (``full_tensor``), then
    the stages' tensors merged, as ``full_state_dict`` gathers the
    parameters."""
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.parallel.sharding import full_tensor, model_splits

    mine = {n: full_tensor(p.grad, model_splits(model, n)).detach().cpu()
            for n, p in model.named_parameters()}
    stages = [None] * model.pp.size
    dist.all_gather_object(stages, mine, group=model.pp.mesh.get_group("pp"))
    return {k: v for stage in stages for k, v in stage.items()}


def rank_pp_feed(world, specs: list, batch: int, microbatches: int) -> list:
    """For each mesh of ``specs``, the rows of a global batch of ``batch``
    rows that this rank's feed takes with ``microbatches`` pipeline
    microbatches (``llama_train``'s: ``check_pp_microbatches``, then
    ``global_batch`` at the rank's data coordinate), and the coordinate."""
    from pytorch_operator_tpu_torch.parallel.data import global_batch
    from pytorch_operator_tpu_torch.parallel.mesh import axis_sizes, make_mesh, train_coords
    from pytorch_operator_tpu_torch.workloads.llama_train import check_pp_microbatches

    out = []
    for spec in specs:
        mesh = make_mesh(spec, "cpu")
        c = train_coords(mesh)
        m = check_pp_microbatches(batch, microbatches, axis_sizes(mesh)["pp"], c.data_extent)
        rows = global_batch(np.arange(batch), c.data_index, c.data_extent, m)
        out.append({"rows": rows.tolist(), "data_index": c.data_index, "pp_index": c.pp_index})
    return out


def rank_restore_layout(world, root: str, step: int, mesh_spec: str, optimizer: str,
                        cfg_over=None) -> dict:
    """Restore step ``step`` of ``root`` (the tiny Llama, with the config's
    ``cfg_over``, and its ``optimizer`` state, written under any layout,
    one process's included) into this world's ``mesh_spec`` layout, built as
    ``llama_train`` builds it. Every record read is counted: the elements
    copied out of the ranks' files, or out of a single-process step's whole
    tensors (memory-mapped, so only those are read). Returns the restored
    parameters and optimizer state as blocks, and the elements read."""
    import torch

    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, manager
    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.sharding import model_axes, model_blocks, shard_model
    from pytorch_operator_tpu_torch.workloads import trainer

    mesh = make_mesh(mesh_spec, "cpu")
    model = llama_lib.Llama(llama_lib.llama_tiny(**(cfg_over or {})), mesh=mesh)
    shard_model(model, mesh)
    opt = trainer.make_optimizer(model, 1e-2, optimizer=optimizer, mesh=mesh)
    if hasattr(opt, "init_state"):
        opt.init_state()
    read = []

    class Spy:
        """A record's tensor that counts the elements taken out of it."""

        def __init__(self, t):
            self.t, self.shape, self.dtype = t, t.shape, t.dtype

        def __getitem__(self, idx):
            part = self.t[idx]
            read.append(part.numel())
            return part

    class WholeSpy(torch.Tensor):
        """A single-process step's whole tensor, counting likewise."""

        def __getitem__(self, idx):
            part = torch.Tensor.__getitem__(self, idx)
            read.append(part.numel())
            return part.as_subclass(torch.Tensor)

    def spy(tree):
        if isinstance(tree, dict) and manager.SHARD in tree and tree[manager.SHARD] is not None:
            return {**tree, manager.SHARD: Spy(tree[manager.SHARD])}
        if isinstance(tree, dict):
            return {k: spy(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor) and tree.dim():
            return tree.as_subclass(WholeSpy)
        return tree

    real_load = torch.load
    torch.load = lambda *a, **kw: spy(real_load(*a, **kw))
    try:
        mgr = CheckpointManager(root, process_id=world.process_id, num_processes=world.num_processes)
        like = {"params": model_blocks(model) if model_axes(model) else model.state_dict(),
                "opt_state": opt.state_dict()}
        restored = mgr.restore(like, step=step)
    finally:
        torch.load = real_load
    model.load_state_dict(restored["params"])
    opt.load_state_dict(restored["opt_state"])
    return {"params": _blocks_out(model_blocks(model)), "opt": _blocks_out(opt.state_dict()),
            "read": sum(read)}


def rank_restore_refused(world, root: str, step: int, mesh_spec: str, cfg_over=None) -> str:
    """The message of the ValueError that restoring step ``step`` of
    ``root`` into this world's ``mesh_spec`` layout (AdamW,
    :func:`rank_restore_layout`) must raise."""
    try:
        rank_restore_layout(world, root, step, mesh_spec, "adamw", cfg_over)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"step {step} of {root} restored into {mesh_spec}")


def rank_attention(world, cases: list) -> list:
    """Sequence-parallel attention on the world's ``sp`` mesh (``sp=n``):
    for each case (``fn``: ``"ring"``, ``"ulysses"`` — the shard bodies on
    this rank's block of the sequence — or ``"ring_global"``,
    ``"ulysses_global"`` — the global views on the whole arrays; ``q``,
    ``k``, ``v``, ``pos`` whole numpy arrays; ``causal``; ``local_pos``: the
    planted fault of masking with each rank's local positions), the output
    and the gradients of q, k and v of the loss ``sum(out²)/numel(q)``
    (this rank's block, or the whole arrays for a global view). Also the
    tiled ``all_to_all`` of ``arange + 100·rank`` over sp."""
    import torch

    from pytorch_operator_tpu_torch.parallel import collectives, ring, ulysses
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh

    n, r = world.num_processes, world.process_id
    mesh = make_mesh({"sp": n}, "cpu")
    out = []
    for case in cases:
        S = case["q"].shape[1]
        whole = case["fn"].endswith("_global")
        mine = slice(None) if whole else slice(r * S // n, (r + 1) * S // n)
        q, k, v = (torch.tensor(case[a][:, mine], requires_grad=True) for a in "qkv")
        pos = torch.from_numpy(case["pos"])
        if case.get("local_pos"):
            local = torch.arange(S // n).expand(pos.shape[0], S // n)
            q_pos = kv_pos = local
        else:
            q_pos = kv_pos = pos[:, mine]
        if case["fn"] == "ring":
            o = ring.ring_attention_shard(q, k, v, q_pos, kv_pos, mesh=mesh, causal=case["causal"])
        elif case["fn"] == "ulysses":
            o = ulysses.ulysses_attention_shard(q, k, v, pos, mesh=mesh, causal=case["causal"])
        elif case["fn"] == "ring_global":
            o = ring.ring_self_attention(q, k, v, pos, mesh, causal=case["causal"])
        else:
            o = ulysses.ulysses_self_attention(q, k, v, pos, mesh, causal=case["causal"])
        ((o.float() ** 2).sum() / case["q"].size).backward()
        out.append({"out": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                    "dv": v.grad.numpy()})
    x = torch.arange(2.0 * n * 3 * n).reshape(2, n * 3, n) + 100 * r
    return {"cases": out, "all_to_all": collectives.all_to_all(x, "sp", 1, 2, mesh).numpy()}


def rank_ulysses_tp(world, cases: list) -> list:
    """Ulysses under tp on an ``sp=2,tp=2`` mesh of the four-rank world
    (``ulysses.ulysses_attention_tp``): for each case (``q``, ``k``, ``v``,
    ``pos`` whole numpy arrays; ``causal``; ``plant`` a :func:`planted`
    fault or None) this rank takes its sp block of the sequence and its tp
    block of the heads, and returns the output and the gradients of q, k
    and v of the loss ``sum(out²)/numel(q)`` (its share of the global
    ``mean(out²)``), its blocks, and the tp gathers it issued."""
    import torch

    from pytorch_operator_tpu_torch.parallel import collectives, ulysses
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh("sp=2,tp=2", "cpu")
    i, t = collectives.axis_index("sp", mesh), collectives.axis_index("tp", mesh)
    out = []
    for case in cases:
        B, S, K = case["k"].shape[:3]
        rows, heads = slice(i * S // 2, (i + 1) * S // 2), slice(t * K // 2, (t + 1) * K // 2)
        q, k, v = (torch.tensor(case[a][:, rows, heads], requires_grad=True) for a in "qkv")
        before = ulysses.tp_gather_count
        with planted(case.get("plant")):
            o = ulysses.ulysses_attention_tp(q, k, v, torch.from_numpy(case["pos"]), mesh=mesh,
                                             causal=case["causal"])
            ((o.float() ** 2).sum() / case["q"].size).backward()
        out.append({"out": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                    "dv": v.grad.numpy(), "rows": (rows.start, rows.stop),
                    "heads": (heads.start, heads.stop), "tp_gathers": ulysses.tp_gather_count - before})
    return out


def rank_moe(world, spec: str, cases: list) -> list:
    """The MoE layer's mesh paths on mesh ``spec`` (``ep``, with or without
    ``tp``): for each case (``fn``: ``"dense"`` for ``moe_mlp``,
    ``"sparse"`` for ``moe_mlp_sparse``; ``params`` whole; ``x``; ``top_k``;
    ``capacity_factor``), this rank takes its experts' block of the banks
    (and tp's block of each expert's F), and returns the output and the
    gradients of the loss ``mean(out²)`` of the router, of its blocks (with
    their offsets) and of x."""
    import torch

    from pytorch_operator_tpu_torch.parallel import moe
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.sharding import ExpertParallel, TensorParallel

    mesh = make_mesh(spec, "cpu")
    ep, tp = ExpertParallel.of(mesh), TensorParallel.of(mesh)
    out = []
    for case in cases:
        p = case["params"]
        e0, en = ep.block(p["w_in"].shape[0], "experts")
        f0, fn = tp.block(p["w_in"].shape[2], "d_ff") if tp is not None else (0, p["w_in"].shape[2])
        params = {
            "gate": torch.tensor(p["gate"], requires_grad=True),
            "w_in": torch.tensor(p["w_in"][e0:e0 + en, :, f0:f0 + fn], requires_grad=True),
            "w_out": torch.tensor(p["w_out"][e0:e0 + en, f0:f0 + fn], requires_grad=True),
        }
        x = torch.tensor(case["x"], requires_grad=True)
        if case["fn"] == "dense":
            y = moe.moe_mlp(params, x, mesh=mesh, top_k=case["top_k"])
        else:
            y = moe.moe_mlp_sparse(params, x, mesh=mesh, top_k=case["top_k"],
                                   capacity_factor=case["capacity_factor"])
        (y ** 2).mean().backward()
        out.append({"out": y.detach().numpy(), "x": x.grad.numpy(), "block": (e0, en, f0, fn),
                    **{k: t.grad.numpy() for k, t in params.items()}})
    return out


def rank_moe_groups(world, cases: list) -> list:
    """The sparse MoE layer over tokens that a mesh splits
    (``moe_mlp_sparse(tokens=)``): for each case (``spec`` the mesh,
    ``params`` whole, ``x`` the global ``[B, S, D]`` tokens,
    ``capacity_factor``, ``group_size``, ``plant``: "rank_groups" groups the
    rank's own tokens, the call without ``tokens``), this rank takes its
    data coordinate's rows (``train_coords``), its sp block of each, and its
    experts' block of the banks, and returns the output, the gradients of
    ``sum(out²) / (B·S·D)`` (the global ``mean(out²)``'s share of its rows)
    of x, the router and its blocks, and where its tokens and experts lie."""
    import torch

    from pytorch_operator_tpu_torch.parallel import moe
    from pytorch_operator_tpu_torch.parallel.mesh import axis_sizes, make_mesh, train_coords
    from pytorch_operator_tpu_torch.parallel.sharding import ExpertParallel

    out = []
    for case in cases:
        mesh = make_mesh(case["spec"], "cpu")
        sizes, c = axis_sizes(mesh), train_coords(mesh)
        B, S, D = case["x"].shape
        rows, n = B // c.data_extent, S // c.sp_size
        r0, s0 = c.data_index * rows, c.sp_index * n
        ep = ExpertParallel.of(mesh)
        p = case["params"]
        e0, en = ep.block(p["w_in"].shape[0], "experts") if ep is not None else (0, p["w_in"].shape[0])
        params = {
            "gate": torch.tensor(p["gate"], requires_grad=True),
            "w_in": torch.tensor(p["w_in"][e0:e0 + en], requires_grad=True),
            "w_out": torch.tensor(p["w_out"][e0:e0 + en], requires_grad=True),
        }
        x = torch.tensor(case["x"][r0:r0 + rows, s0:s0 + n].reshape(-1, D), requires_grad=True)
        axes = tuple(a for a in ("dp", "fsdp", "sp") if sizes.get(a, 1) > 1)
        tokens = None if case.get("plant") == "rank_groups" else moe.TokenSplit(axes, rows, S, mesh)
        y = moe.moe_mlp_sparse(params, x, top_k=2, capacity_factor=case["capacity_factor"],
                               group_size=case["group_size"], mesh=mesh if ep is not None else None,
                               tokens=tokens)
        ((y ** 2).sum() / (B * S * D)).backward()
        out.append({"out": y.detach().numpy(), "x": x.grad.numpy(), "rows": (r0, rows),
                    "block": (s0, n), "experts": (e0, en), "data_index": c.data_index,
                    **{k: t.grad.numpy() for k, t in params.items()}})
    return out


def _toy_stage(params, x):
    """``tests/test_pipeline.py``'s stage: x + tanh(x @ w + b)."""
    import torch

    return x + torch.tanh(x @ params["w"] + params["b"])


def _toy_loss(lp, y, tgt):
    """``tests/test_pipeline.py``'s tail: a linear head, squared error."""
    return ((y @ lp["head"] - tgt) ** 2).mean()


def _sharded_toy_loss(kp: int, mesh):
    """``tests/test_pipeline.py``'s column-chunked tail: each stage's
    ``kp`` head columns against its columns of the targets, the partial
    sums combined over pp (``tp_leave``: the sum, its gradient passed to
    each stage's part)."""
    from pytorch_operator_tpu_torch.parallel.collectives import axis_index, tp_leave

    def loss(lp, y, tgt):
        off = axis_index("pp", mesh) * kp
        partial = ((y @ lp["head"] - tgt[:, off:off + kp]) ** 2).sum()
        return tp_leave(partial, "pp", mesh) / (tgt.shape[0] * tgt.shape[1])

    return loss


def rank_pipeline(world, cases: list) -> list:
    """Each case of ``cases`` through the port's ``parallel/pipeline.py`` on
    a ``pp`` mesh of the whole world: ``kind`` "apply" (``pipeline_apply``),
    "grad" (``pipeline_value_and_grad``, ``schedule``, ``backward``,
    ``sharded``), or "error" (the message of the ValueError a call with
    ``call`` raises). The stacked parameters come whole (``layout``
    "stacked") or as this rank's slice with a leading axis of 1 ("local").
    Each grad case also reports the most tensors autograd kept saved at once
    (``saved_max``, counted through ``saved_tensors_hooks``), those still
    saved after the call (``saved_after``), and the tensors one forward of
    this stage on one microbatch saves (``per_mb``) and one call of the
    last stage's loss (``per_tail``; None with ``sharded``)."""
    import torch

    from pytorch_operator_tpu_torch.parallel import pipeline
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh

    n, r = world.num_processes, world.process_id
    mesh = make_mesh(f"pp={n}", "cpu")

    def tensors(tree, local):
        return {k: torch.tensor(v[r:r + 1] if local else v, requires_grad=True) for k, v in tree.items()}

    out = []
    for case in cases:
        local = case.get("layout") == "local"
        params = tensors(case["params"], local)
        x = torch.tensor(case["x"], requires_grad=False)
        M = case["M"]
        if case["kind"] == "apply":
            y = pipeline.pipeline_apply(_toy_stage, params, x, mesh=mesh, microbatches=M)
            out.append({"y": y.numpy()})
            continue
        sharded = case.get("sharded", False)
        lp = tensors(case["lp"], local and sharded)
        loss_fn = _sharded_toy_loss(case["kp"], mesh) if sharded else _toy_loss
        kw = dict(mesh=mesh, microbatches=M, schedule=case.get("schedule", "1f1b"),
                  sharded_loss=sharded, backward=case.get("backward", "recompute"))
        if case["kind"] == "error":
            try:
                if case["call"] == "apply":
                    pipeline.pipeline_apply(_toy_stage, params, x, mesh=mesh, microbatches=M)
                else:
                    pipeline.pipeline_value_and_grad(_toy_stage, loss_fn, params, lp, x,
                                                     torch.tensor(case["tgt"]), **kw)
            except ValueError as e:
                out.append(str(e))
                continue
            raise AssertionError(f"case {case} did not raise")
        live, peak = [0], [0]

        class Saved:
            def __init__(self, t):
                self.t = t
                live[0] += 1
                peak[0] = max(peak[0], live[0])

            def __del__(self):
                live[0] -= 1

        def saved_by(fn):
            live[0] = peak[0] = 0
            with torch.autograd.graph.saved_tensors_hooks(Saved, lambda h: h.t), torch.enable_grad():
                fn()
            return peak[0]

        mb = x.shape[0] // M
        act = x[:mb].clone().requires_grad_()
        per_mb = saved_by(lambda: _toy_stage({k: v[0 if local else r] for k, v in params.items()}, act))
        per_tail = None if sharded else saved_by(
            lambda: _toy_loss(lp, act, torch.tensor(case["tgt"][:mb])))
        live[0] = peak[0] = 0
        with torch.autograd.graph.saved_tensors_hooks(Saved, lambda h: h.t):
            loss, (dsp, dlp, dx) = pipeline.pipeline_value_and_grad(
                _toy_stage, loss_fn, params, lp, x, torch.tensor(case["tgt"]), **kw)
        out.append({
            "loss": float(loss), "dsp": {k: v.numpy() for k, v in dsp.items()},
            "dlp": None if dlp is None else {k: v.numpy() for k, v in dlp.items()},
            "dx": None if dx is None else dx.numpy(),
            "saved_max": peak[0], "saved_after": live[0], "per_mb": per_mb, "per_tail": per_tail,
        })
    return out


def rank_pp_vocab(world, vocab: int, steps: int, M: int) -> dict:
    """A tiny Llama (2 layers, ``vocab``) as one pp stage of the world's
    ``pp=n`` mesh, seed-0 init, ``steps`` 1F1B steps of AdamW (lr 1e-3) over
    ``M`` microbatches of the synthetic bigram batch of each step: the
    losses, the warnings raised, this stage's head shape and the whole
    trained parameters."""
    import warnings

    import torch

    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.sharding import full_state_dict
    from pytorch_operator_tpu_torch.workloads import trainer
    from pytorch_operator_tpu_torch.workloads.llama_train import synthetic_bigram_batch

    mesh = make_mesh(f"pp={world.num_processes}", "cpu")
    model = llama_lib.Llama(llama_lib.llama_tiny(vocab_size=vocab), mesh=mesh)
    model.init_weights(torch.Generator().manual_seed(0))
    opt = trainer.make_optimizer(model, 1e-3)
    step = trainer.make_lm_train_step(model, opt, microbatches=M, pp_schedule="1f1b")
    losses = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(steps):
            tokens = torch.from_numpy(synthetic_bigram_batch(8, 16, vocab, i)).long()
            losses.append(float(step(tokens)))
    return {"losses": losses, "warnings": [str(w.message) for w in caught],
            "head": None if model.lm_head is None else tuple(model.lm_head.weight.shape),
            "params": {k: v.numpy() for k, v in full_state_dict(model).items()}}


# Runs the JAX package's llama_train.run of each case in a process whose XLA
# client has as many CPU devices as the case's world; each run's final
# parameters come back through its own checkpoint.
JAX_RUNS = """
import os, pickle, sys
import tests.jaxenv
from pytorch_operator_tpu.checkpoint import CheckpointManager
from pytorch_operator_tpu.workloads import llama_train
import jax
cases, out_dir, n = pickle.load(open(sys.argv[1], "rb")), sys.argv[2], int(sys.argv[3])
assert jax.device_count() == n, jax.devices()
out = {}
for name, kw in cases.items():
    ck = os.path.join(out_dir, "ck_" + name)
    os.environ["TPUJOB_CHECKPOINT_DIR"] = ck
    r = llama_train.run(log=lambda m: None, checkpoint_every=1000, **kw)
    _, params = CheckpointManager(ck, create=False).restore_subtree("params")
    out[name] = {"result": r, "params": jax.tree.map(lambda a: a.astype("float32"), params)}
pickle.dump(out, open(os.path.join(out_dir, "jax.pkl"), "wb"))
"""


def start_jax_runs(cases: dict, n_devices: int, d):
    """Start the JAX package's ``llama_train.run`` of each of ``cases`` (name:
    kwargs) in a subprocess with ``n_devices`` virtual CPU devices; read the
    results with :func:`finish_jax_runs`."""
    import subprocess
    import sys

    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    (d / "cases.pkl").write_bytes(pickle.dumps(cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}")
    return subprocess.Popen(
        [sys.executable, "-c", JAX_RUNS, str(d / "cases.pkl"), str(d), str(n_devices)],
        cwd=Path(__file__).resolve().parents[1], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )


def finish_jax_runs(proc, d, timeout: float = 400) -> dict:
    """The results of :func:`start_jax_runs` (name: ``{"result", "params"}``)."""
    _, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return pickle.loads((Path(d) / "jax.pkl").read_bytes())


# The JAX package's runs of each case, in a process whose XLA client has as
# many CPU devices as the case's world, each step's loss recorded around its
# train step: llama_train.run of a case's kwargs (the final parameters come
# back through its checkpoint), or, for a case with "model", the tiny Llama
# at 4 layers with dense attention and the config's overrides "model"
# through tests/test_llama_pp.py's _train on "mesh" (optax's adamw(1e-3), the
# key-0 init) over "tokens" (the losses only).
JAX_RECORDED = """
import os, pickle, sys
import tests.jaxenv
import jax
from pytorch_operator_tpu.checkpoint import CheckpointManager
from pytorch_operator_tpu.models import llama as jax_llama
from pytorch_operator_tpu.workloads import llama_train, trainer
cases, out_dir, n = pickle.load(open(sys.argv[1], "rb")), sys.argv[2], int(sys.argv[3])
assert jax.device_count() == n, jax.devices()
losses = []
make = trainer.make_lm_train_step

def recording(*a, **kw):
    step = make(*a, **kw)

    def run(state, tokens):
        state, loss = step(state, tokens)
        losses.append(float(jax.device_get(loss)))
        return state, loss

    return run

trainer.make_lm_train_step = recording
out = {}
for name, kw in cases.items():
    losses.clear()
    if "model" in kw:
        from tests.test_llama_pp import _train

        cfg = jax_llama.llama_tiny(n_layers=4, attn_impl="dense", **kw["model"])
        _train(cfg, kw["mesh"], jax.numpy.asarray(kw["tokens"]), steps=kw["steps"],
               pp_schedule=kw["schedule"])
        out[name] = {"losses": list(losses)}
        continue
    ck = os.path.join(out_dir, "ck_" + name)
    os.environ["TPUJOB_CHECKPOINT_DIR"] = ck
    r = llama_train.run(log=lambda m: None, checkpoint_every=1000, **kw)
    _, params = CheckpointManager(ck, create=False).restore_subtree("params")
    r["losses"] = list(losses)
    out[name] = {"result": r, "params": jax.tree.map(lambda a: a.astype("float32"), params)}
pickle.dump(out, open(os.path.join(out_dir, "jax.pkl"), "wb"))
"""


# The JAX package's bert_fsdp.run of each case (name: kwargs), in a process
# whose XLA client has as many CPU devices as the case's world: every
# step's loss recorded around its train step, and the final parameters
# taken from the state the step loop returns.
JAX_BERT_RECORDED = """
import os, pickle, sys
import tests.jaxenv
import jax
import numpy as np
from pytorch_operator_tpu.workloads import bert_fsdp, trainer
cases, out_dir, n = pickle.load(open(sys.argv[1], "rb")), sys.argv[2], int(sys.argv[3])
assert jax.device_count() == n, jax.devices()
real = trainer.throughput_loop
rec = {}

def loop(train_step, state, batches, **kw):
    def recorded(state, b):
        state, loss = train_step(state, b)
        rec["losses"].append(float(jax.device_get(loss)))
        return state, loss

    got = real(recorded, state, batches, **kw)
    rec["params"] = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.device_get(got[0]["params"]))
    return got

trainer.throughput_loop = loop
out = {}
for name, kw in cases.items():
    rec.clear()
    rec["losses"] = []
    r = bert_fsdp.run(log=lambda m: None, **kw)
    out[name] = {"result": r, "losses": list(rec["losses"]), "params": rec["params"]}
pickle.dump(out, open(os.path.join(out_dir, "jax.pkl"), "wb"))
"""


def start_jax_recorded(cases: dict, n_devices: int, d, script: str = JAX_RECORDED):
    """Start :data:`JAX_RECORDED` (or ``script``, e.g.
    :data:`JAX_BERT_RECORDED`) over ``cases`` (name: kwargs) with
    ``n_devices`` virtual CPU devices; read the results with
    :func:`finish_jax_runs`."""
    import subprocess
    import sys

    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    (d / "cases.pkl").write_bytes(pickle.dumps(cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}")
    return subprocess.Popen(
        [sys.executable, "-c", script, str(d / "cases.pkl"), str(d), str(n_devices)],
        cwd=Path(__file__).resolve().parents[1], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )


def jax_init(seq_len: int = 16, **over) -> dict:
    """The JAX tiny Llama's key-0 init at 4 layers (with the config's
    ``over``) as a tree of numpy arrays, as ``llama_train.run`` and
    ``tests/test_llama_pp.py``'s ``_train`` draw it. In the test process
    only: a rank imports no jax."""
    import flax.linen as nn
    import jax

    from pytorch_operator_tpu.models import llama as jax_llama

    model = jax_llama.Llama(jax_llama.llama_tiny(n_layers=4, **over))
    params = model.init(jax.random.key(0), np.zeros((1, seq_len), np.int32))["params"]
    return jax.device_get(nn.meta.unbox(params))


def rank_many(world, calls: list) -> list:
    """Run each ``(name, args)`` of ``calls`` as ``rank_<name>(world,
    *args)`` in this one world, in order; their results."""
    return [globals()[f"rank_{name}"](world, *args) for name, args in calls]


def rank_bert_runs(world, init: dict, runs: list) -> list:
    """``bert_fsdp.run(device="cpu", init_params=init, keep_params=True,
    **kw)`` for each ``kw`` of ``runs`` in this world (``kw["plant"]``
    names a :func:`planted` fault to run it under); each result, its
    ``params`` as numpy arrays."""
    from pytorch_operator_tpu_torch.workloads import bert_fsdp

    out = []
    for kw in runs:
        kw = dict(kw)
        with planted(kw.pop("plant", None)):
            r = bert_fsdp.run(device="cpu", log=lambda m: None, init_params=init, keep_params=True, **kw)
        r["params"] = {name: t.numpy() for name, t in r["params"].items()}
        out.append(r)
    return out


def rank_bert_tp_module(world, tree, mesh_spec: str, cases: list) -> list:
    """BERT's heads built with the tp axis of ``mesh_spec`` from the JAX
    ``tree`` (``bert_params_from_jax(tree, tp=...)``; with ``type_embed``
    where the tree holds one), one forward and
    backward for each case of ``cases``: a dict of ``head``
    (``"classifier"`` or ``"mlm"``), ``tokens``, ``type_ids``, ``pad_mask``,
    ``labels``, ``classes`` and ``plant`` (a :func:`planted` fault or
    None), the classifier's loss its cross-entropy,
    the MLM's the mean square of its logits. Each case's sequence output,
    logits, and every gradient gathered whole (``sharding.full_tensor``),
    as numpy."""
    import torch
    import torch.nn.functional as F

    from pytorch_operator_tpu_torch.models import bert
    from pytorch_operator_tpu_torch.models.convert import bert_params_from_jax
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.sharding import TensorParallel, full_tensor, model_splits

    tp = TensorParallel.of(make_mesh(mesh_spec, "cpu"))

    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a)) if a.dtype == bool \
            else torch.from_numpy(np.asarray(a)).long()

    out = []
    types = "type_embed" in tree["bert"]
    for case in cases:
        inputs = (t(case["tokens"]), t(case["type_ids"]), t(case["pad_mask"]))
        with planted(case["plant"]):
            cfg = bert.bert_tiny()
            model = (bert.BertClassifier(cfg, case["classes"], type_embed=types, tp=tp)
                     if case["head"] == "classifier" else bert.BertMLM(cfg, type_embed=types, tp=tp))
            model.load_state_dict(bert_params_from_jax(tree, tp=tp))
            seq, _ = model.bert(*inputs)
            logits = model(*inputs)
            loss = (F.cross_entropy(logits, t(case["labels"])) if case["head"] == "classifier"
                    else logits.square().mean())
            loss.backward()
            grads = {n: full_tensor(torch.zeros_like(p) if p.grad is None else p.grad,
                                    model_splits(model, n)).numpy()
                     for n, p in model.named_parameters()}
        out.append({"seq": seq.detach().numpy(), "logits": logits.detach().numpy(), "grads": grads,
                    "tp_index": tp.index})
    return out


def rank_bert_shard(world, mesh_spec: str) -> dict:
    """``shard_model`` on ``mesh_spec`` of a BERT classifier (the mesh dim
    names of its parameters' FSDP2 layout) and of a Llama without ep blocks
    (the refusal's message)."""
    from pytorch_operator_tpu_torch.models import bert, llama
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.sharding import shard_model

    mesh = make_mesh(mesh_spec, "cpu")
    model = shard_model(bert.BertClassifier(bert.bert_tiny(), 2, mesh=mesh), mesh)
    out = {"bert": list(model.classifier.weight.device_mesh.mesh_dim_names)}
    try:
        shard_model(llama.Llama(llama.llama_tiny(n_layers=2), device="meta"), mesh)
    except ValueError as e:
        out["llama"] = str(e)
    return out


def rank_workload(world, module: str, kw: dict) -> dict:
    """``pytorch_operator_tpu_torch.workloads.<module>.run(**kw)`` in this
    world, on the CPU (``mnist_train``, ``bert_fsdp``)."""
    import importlib

    mod = importlib.import_module(f"pytorch_operator_tpu_torch.workloads.{module}")
    return mod.run(device="cpu", log=lambda m: None, **kw)


def supervise(tmp_path, job, timeout: float = 240):
    """Run ``job`` to its end under the unchanged supervisor (state under
    ``tmp_path``): the finished job, Master 0's log and its status records."""
    import json

    from pytorch_operator_tpu.controller import Supervisor
    from pytorch_operator_tpu.controller.progress import job_status_dir
    from pytorch_operator_tpu.controller.store import job_key

    job.spec.port = None
    sup = Supervisor(state_dir=tmp_path / "state", poll_interval=0.1)
    try:
        done = sup.run(job, timeout=timeout)
    finally:
        sup.shutdown()
    name = job.metadata.name
    log = (tmp_path / "state" / "logs" / f"default_{name}-master-0.log").read_text()
    status = job_status_dir(tmp_path / "state" / "status", job_key(done)) / "master-0.jsonl"
    records = [json.loads(x) for x in status.read_text().splitlines()] if status.exists() else []
    return done, log, records


def rank_sp_cost(world, cases: list) -> list:
    """Each ``(scheme, S)`` of ``cases``: one forward and backward of this
    rank's sequence block through ``ring_attention_shard`` or
    ``ulysses_attention_shard`` over the whole world (f32, seeded values),
    or (``("ulysses_tp", S, K)``, four ranks) through
    ``ulysses_attention_tp`` on an ``sp=2,tp=2`` mesh of the world with
    ``K`` global kv heads (this rank's ``K/2``), with the collectives it
    really issued (``batch_isend_irecv`` for a ``ppermute``,
    ``all_to_all_single`` for an ``all_to_all``, ``all_gather_into_tensor``
    for an ``all_gather``: calls and the bytes this rank sent) beside
    ``count_collectives`` of the same call at this rank's coordinates."""
    import torch
    import torch.distributed as dist

    from pytorch_operator_tpu_torch.ops.flop_count import count_collectives
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.ring import ring_attention_shard
    from pytorch_operator_tpu_torch.parallel.ulysses import ulysses_attention_shard, ulysses_attention_tp

    n, r = world.num_processes, world.process_id
    B, K, G, D = 1, 4, 2, 8
    real = {}

    def record(name, n_bytes):
        calls, sent = real.get(name, (0, 0))
        real[name] = (calls + 1, sent + n_bytes)

    p2p, a2a, gather = dist.batch_isend_irecv, dist.all_to_all_single, dist.all_gather_into_tensor

    def counting_p2p(ops):
        record("ppermute", sum(op.tensor.numel() * op.tensor.element_size()
                               for op in ops if op.op is dist.isend))
        return p2p(ops)

    def counting_a2a(out, inp, *a, **kw):
        record("all_to_all", inp.numel() * inp.element_size())
        return a2a(out, inp, *a, **kw)

    def counting_gather(out, inp, *a, **kw):
        record("all_gather", inp.numel() * inp.element_size())
        return gather(out, inp, *a, **kw)

    tp_mesh = make_mesh("sp=2,tp=2", "cpu") if any(c[0] == "ulysses_tp" for c in cases) else None

    def attend(scheme, S, q, k, v):
        blk = S // n
        if scheme == "ulysses_tp":
            pos = torch.arange(S, dtype=torch.int32)[None]
            out = ulysses_attention_tp(q, k, v, pos.to(q.device), mesh=tp_mesh)
        elif scheme == "ring":
            pos = torch.arange(r * blk, (r + 1) * blk, dtype=torch.int32, device=q.device)[None]
            if q.is_meta:
                pos = pos.to("meta")
            out = ring_attention_shard(q, k, v, pos, pos, axis_name="sp")
        else:
            pos = torch.arange(S, dtype=torch.int32)[None]
            out = ulysses_attention_shard(q, k, v, pos.to(q.device), axis_name="sp")
        out.float().sum().backward()
        return out

    results = []
    for scheme, S, *heads in cases:
        if scheme == "ulysses_tp":
            sizes = {"sp": 2, "tp": 2}
            coords = {a: tp_mesh.get_local_rank(a) for a in sizes}
            blk, kh = S // 2, heads[0] // 2
        else:
            sizes, coords, blk, kh = {"sp": n}, {"sp": r}, S // n, K
        g = torch.Generator().manual_seed(r)
        q = torch.randn(B, blk, kh, G, D, generator=g).requires_grad_()
        k = torch.randn(B, blk, kh, D, generator=g).requires_grad_()
        v = torch.randn(B, blk, kh, D, generator=g).requires_grad_()
        real.clear()
        dist.batch_isend_irecv, dist.all_to_all_single = counting_p2p, counting_a2a
        dist.all_gather_into_tensor = counting_gather
        try:
            attend(scheme, S, q, k, v)
        finally:
            dist.batch_isend_irecv, dist.all_to_all_single = p2p, a2a
            dist.all_gather_into_tensor = gather
        counted = count_collectives(lambda *t: attend(scheme, S, *t), q, k, v, axes=sizes,
                                    coords=coords)
        results.append({"real": dict(real), "calls": counted.calls, "bytes": counted.bytes,
                        "grad_finite": bool(torch.isfinite(q.grad).all())})
    return results
