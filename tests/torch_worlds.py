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
      that dim."""
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
        elif name == "unreduced_rows":
            where, attr = trainer.Adafactor, "_mean"
            sound = trainer.Adafactor._mean

            def fault(self, x, dims, lay, leaf_dims, keepdim=False):
                factored = trainer._factored_dims(lay.whole)
                if factored is not None and list(leaf_dims) == [factored[1]] and not keepdim:
                    return x.mean(dims)
                return sound(self, x, dims, lay, leaf_dims, keepdim)
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
    """``tree`` with each ``sharding.Block`` as a dict of its offsets, whole
    shape, writer flag and data (numpy, f32 for bf16), for the test process
    to assemble the whole from the ranks' parts."""
    from pytorch_operator_tpu_torch.parallel.sharding import Block

    if isinstance(tree, Block):
        return {"offsets": tuple(tree.offsets), "shape": tuple(tree.shape), "writer": tree.writer,
                "data": tree.data.detach().float().numpy().copy()}
    if isinstance(tree, dict):
        return {k: _blocks_out(v) for k, v in tree.items()}
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


def rank_restore_layout(world, root: str, step: int, mesh_spec: str, optimizer: str) -> dict:
    """Restore step ``step`` of ``root`` (the tiny Llama and its
    ``optimizer`` state, written under any layout) into this world's
    ``mesh_spec`` layout, built as ``llama_train`` builds it. Every record
    read is counted: the elements copied out of the ranks' files (a record
    memory-mapped, so only those are read). Returns the restored parameters
    and optimizer state as blocks, and the elements read."""
    import torch

    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, manager
    from pytorch_operator_tpu_torch.models import llama as llama_lib
    from pytorch_operator_tpu_torch.parallel.mesh import make_mesh
    from pytorch_operator_tpu_torch.parallel.sharding import TensorParallel, model_blocks, shard_model
    from pytorch_operator_tpu_torch.workloads import trainer

    mesh = make_mesh(mesh_spec, "cpu")
    tp = TensorParallel.of(mesh)
    model = llama_lib.Llama(llama_lib.llama_tiny(), tp=tp)
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

    def spy(tree):
        if isinstance(tree, dict) and manager.SHARD in tree and tree[manager.SHARD] is not None:
            return {**tree, manager.SHARD: Spy(tree[manager.SHARD])}
        if isinstance(tree, dict):
            return {k: spy(v) for k, v in tree.items()}
        return tree

    real_load = torch.load
    torch.load = lambda *a, **kw: spy(real_load(*a, **kw))
    try:
        mgr = CheckpointManager(root, process_id=world.process_id, num_processes=world.num_processes)
        like = {"params": model_blocks(model) if tp is not None else model.state_dict(),
                "opt_state": opt.state_dict()}
        restored = mgr.restore(like, step=step)
    finally:
        torch.load = real_load
    model.load_state_dict(restored["params"])
    opt.load_state_dict(restored["opt_state"])
    return {"params": _blocks_out(model_blocks(model)), "opt": _blocks_out(opt.state_dict()),
            "read": sum(read)}
