"""Run one cell of the benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted`` (the windows' steps), ``failed`` (steps whose loss is not
finite), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown`` (the
device ops that took most time and the longest idle gaps by what the host
was doing), ``kernels_built`` (the port's kernels this run compiled, which
a checkout's first run does inside its set-up), and last ``checks``: each
number compared with its limit. The same numbers are the last lines of
standard error.

The run needs as many CUDA cards as the cell asks for, and exits with 2
without a result when they are not there. It exits with 3 without a result
when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """This process's start on the ``time.perf_counter()`` clock, from
    ``/proc`` (to 10 ms); the time of this call where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))


_T_PROCESS = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from . import harness  # noqa: E402


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, _T_PROCESS)

    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    limit = power_limit()
    if limit:
        print(f"card: {limit}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
