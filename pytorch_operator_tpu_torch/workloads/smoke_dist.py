"""Distributed smoke test, the rendezvous and collectives canary — the port
of ``pytorch_operator_tpu/workloads/smoke_dist.py``.

The upstream's ``examples/smoke-dist/dist_sendrecv.py`` is a
``dist.send``/``recv`` ring proving the operator's environment wiring end to
end. This joins the world from the supervisor-injected environment
(``runtime.rendezvous.initialize_from_env``), then on the rank's device:

1. all-gathers every rank's id (the rendezvous and its addressing),
2. sums a value a rank over the world (a cross-process reduction),
3. shifts a value a rank one place around the ring (``batch_isend_irecv``).

It exits 0 only if all three pass on this rank (a rank that finds a fault
exits 1, and the supervisor sees the job fail), after
``report_first_step``.

    python -m pytorch_operator_tpu_torch.workloads.smoke_dist
"""

from __future__ import annotations

import sys

import torch

from ..parallel import collectives
from ..parallel.mesh import make_mesh
from ..runtime import rendezvous
from ..runtime.device import rank_device


def checks(world: rendezvous.WorldInfo, dev: torch.device, mesh=None) -> list:
    """The three checks on this rank, over the ``dp`` axis of ``mesh`` (the
    whole world); the failures, as messages (empty: all passed)."""
    n = world.num_processes
    fails = []
    ranks = collectives.all_gather(
        torch.tensor([world.process_id], dtype=torch.int64, device=dev), "dp", mesh
    )
    if sorted(ranks.tolist()) != list(range(n)):
        fails.append(f"all_gather: got {sorted(ranks.tolist())}, want {list(range(n))}")
    x = torch.tensor([float(world.process_id)], device=dev)  # this rank's shard of arange(n)
    total = float(collectives.psum(x, "dp", mesh).sum())
    if total != n * (n - 1) / 2:
        fails.append(f"psum: got {total}, want {n * (n - 1) / 2}")
    shifted = collectives.all_gather(collectives.ring_shift(x, "dp", mesh, shift=1), "dp", mesh)
    want = torch.roll(torch.arange(float(n)), 1).tolist()
    if shifted.tolist() != want:
        fails.append(f"ring_shift: got {shifted.tolist()}, want {want}")
    return fails


def main(argv=None) -> int:
    world = rendezvous.initialize_from_env()
    if world.num_processes > 1:
        dev = torch.device(world.device)
        mesh = make_mesh({"dp": world.num_processes}, dev.type)
    else:
        dev, mesh = rank_device(0), None
    print(
        f"[smoke-dist] rank {world.process_id}/{world.num_processes}: backend "
        f"{world.backend or 'none'}, device {dev}",
        flush=True,
    )
    fails = checks(world, dev, mesh)
    for msg in fails:
        print(f"[smoke-dist] FAIL {msg}", flush=True)
    code = 1 if fails else 0
    if not fails:
        rendezvous.report_first_step()
        print(f"[smoke-dist] rank {world.process_id}: OK", flush=True)
    rendezvous.finalize(world, code)
    return code


if __name__ == "__main__":
    sys.exit(main())
