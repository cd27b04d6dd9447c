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


def rank_train(world, runs: list) -> list:
    """``llama_train.run(device="cpu", **kw)`` for each ``kw`` of ``runs``
    in this world (``kw["env"]``, if given, is set in the environment
    first); each run's result, with ``params``: the whole trained
    parameters (gathered from the shards) as numpy arrays. A run with
    ``kw["raises"]`` must raise that exception type: its message is the
    result."""
    from pytorch_operator_tpu_torch.workloads import llama_train

    out = []
    for kw in runs:
        kw = dict(kw)
        os.environ.update(kw.pop("env", {}))
        raises = kw.pop("raises", None)
        if raises is not None:
            try:
                llama_train.run(device="cpu", log=lambda m: None, **kw)
            except raises as e:
                out.append(str(e))
                continue
            raise AssertionError(f"run({kw}) did not raise {raises.__name__}")
        r = llama_train.run(device="cpu", log=lambda m: None, keep_params=True, **kw)
        r["params"] = {name: t.numpy() for name, t in r["params"].items()}
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
    from pytorch_operator_tpu_torch.parallel.sharding import shard_model

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
        offset, _ = manager._shard_rows(t.shape, t.device_mesh, t.placements)
        out[name] = (offset, t.to_local().numpy().copy())
    return {"rows": out, "whole_raised": whole_raised}
