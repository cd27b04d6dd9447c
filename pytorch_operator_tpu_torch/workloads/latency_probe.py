"""Schedule-to-first-step latency probe — the port of
``pytorch_operator_tpu/workloads/latency_probe.py``.

The second north-star metric (BASELINE.json:2) is submit-accepted → first
training step executed. This workload is the least honest "training step":
spawned by the supervisor, it joins the world, imports torch, brings up the
rank's device, runs one fixed 256×256 bf16 ``(x @ x).sum()`` step, reads it
back and reports the first step through the status channel every workload
uses (``rendezvous.report_first_step``).

Its ``latency_phases`` record splits the time after main entry:
``rendezvous_s`` (the join), ``import_torch_s`` (in place of JAX's
``import_jax_s``; in a world of several processes the rendezvous has
imported torch already), ``client_init_s`` (on the card the CUDA context:
``torch.cuda.init()`` and a device query; on the CPU, which the supervisor
selects with ``TPUJOB_PLATFORM=cpu``, there is none to bring up) and
``first_exec_s`` (the step and its read-back). Eager PyTorch compiles
nothing, so there is no ``compile_s``: cuBLAS's lazy initialisation falls in
``first_exec_s``.
"""

from __future__ import annotations

import sys
import time

from ..runtime import rendezvous


def main() -> int:
    t_main = time.time()
    world = rendezvous.initialize_from_env()
    t0 = time.time()
    import torch

    from ..runtime.device import device_name, rank_device

    t_import = time.time()
    dev = rank_device(world.process_id)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.get_device_properties(dev)
    t_client = time.time()
    x = torch.ones((256, 256), dtype=torch.bfloat16, device=dev)
    float((x @ x).sum())
    t_exec = time.time()
    rendezvous.report_first_step(0)
    rendezvous.report(
        "latency_phases",
        main_entry=t_main,
        rendezvous_s=round(t0 - t_main, 3),
        import_torch_s=round(t_import - t0, 3),
        client_init_s=round(t_client - t_import, 3),
        first_exec_s=round(t_exec - t_client, 3),
    )
    print(
        f"[latency-probe] rank {world.process_id}/{world.num_processes} "
        f"first step done on {device_name(dev)}",
        flush=True,
    )
    rendezvous.finalize(world)
    return 0


if __name__ == "__main__":
    sys.exit(main())
