"""Probe: does PyTorch's own tensor parallelism run in two ranks that share
one GPU over gloo?

    python3 tools/probe_tp.py [--device cuda|cpu]

Each case runs in a fresh world of two ranks (subprocesses joined over gloo
at a local TCP store), so that a crash in one case leaves the others to run:

- ``forward``: ``parallelize_module`` with ``ColwiseParallel`` on the first
  ``nn.Linear`` of a two-layer MLP and ``RowwiseParallel`` on the second;
  one forward, held against the unsharded MLP;
- ``backward``: the same, then ``backward`` of the output's sum; the
  sharded weight's gradient held against the unsharded one's rows;
- ``full_tensor``: ``DTensor.full_tensor`` of the column-parallel weight;
- ``c10d_bf16`` and ``c10d_max``: plain ``dist.all_reduce`` (SUM of a bf16
  tensor, MAX of an f32 tensor) on the device's tensors.

Prints one JSON object: each case's exit codes (a negative code is the
signal that killed the rank), its checks, and the tail of a failed rank's
stderr. Exits 0 whatever the outcome: it reports, it does not judge.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

CASES = ("forward", "backward", "full_tensor", "c10d_bf16", "c10d_max")
TIMEOUT_S = 180


def _rank(case: str, device: str) -> dict:
    import torch
    import torch.distributed as dist
    from torch import nn

    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}", rank=rank, world_size=n
    )
    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = {}
    if case.startswith("c10d"):
        if case == "c10d_bf16":
            x = torch.full((1024,), 1.5 + rank, dtype=torch.bfloat16, device=dev)
            dist.all_reduce(x)
            out["ok"] = bool((x == sum(1.5 + r for r in range(n))).all())
        else:
            x = torch.arange(1024.0, device=dev) * (rank + 1)
            dist.all_reduce(x, op=dist.ReduceOp.MAX)
            out["ok"] = bool(torch.equal(x, torch.arange(1024.0, device=dev) * n))
        return out
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    torch.manual_seed(0)
    ref = nn.Sequential(nn.Linear(256, 1024, bias=False), nn.ReLU(), nn.Linear(1024, 256, bias=False))
    ref = ref.to(dev)
    model = nn.Sequential(nn.Linear(256, 1024, bias=False), nn.ReLU(), nn.Linear(1024, 256, bias=False))
    model.load_state_dict(ref.state_dict())
    model = model.to(dev)
    x = torch.randn(8, 256, generator=torch.Generator().manual_seed(1)).to(dev)
    mesh = init_device_mesh(dev.type, (n,), mesh_dim_names=("tp",))
    parallelize_module(model, mesh, {"0": ColwiseParallel(), "2": RowwiseParallel()})
    out["stage"] = "parallelized"
    if case == "full_tensor":
        w = model[0].weight.full_tensor()
        out["full_tensor_equal"] = bool(torch.equal(w, ref[0].weight))
        return out
    y = model(x)
    y_ref = ref(x)
    out["stage"] = "forward"
    out["forward_max_abs_err"] = float((y - y_ref).abs().max())
    if case == "backward":
        y.sum().backward()
        y_ref.sum().backward()
        out["stage"] = "backward"
        g = model[0].weight.grad.to_local()
        rows = ref[0].weight.grad.chunk(n)[rank]
        out["grad_max_abs_err"] = float((g - rows).abs().max())
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(case: str, device: str) -> dict:
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONFAULTHANDLER="1")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank", case, "--device", device], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    result = {"exit_codes": [], "ranks": []}
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(TIMEOUT_S - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            result["timed_out"] = True
        result["exit_codes"].append(p.returncode)
        line = out.strip().splitlines()[-1] if out.strip() else ""
        try:
            result["ranks"].append(json.loads(line))
        except ValueError:
            result["ranks"].append(None)
        if p.returncode != 0:
            result.setdefault("stderr_tail", []).append(err[-1500:])
    result["seconds"] = round(time.perf_counter() - t0, 1)
    return result


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.rank is not None:
        print(json.dumps(_rank(args.rank, args.device)), flush=True)
        sys.stdout.flush()
        os._exit(0)  # no gloo thread may race the interpreter's teardown
    import torch

    report = {"torch": torch.__version__, "cuda": torch.version.cuda, "device": args.device}
    if args.device == "cuda":
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
    report["cases"] = {case: _world(case, args.device) for case in CASES}
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
