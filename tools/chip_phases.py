"""Some phases of a checkout's ``chip_smoke.py``, timed, to price a change
to them against another checkout on one card:

    python3 tools/chip_phases.py TREE [PHASE ...]

runs, in TREE (a checkout of the repo, e.g. a commit unpacked with ``git
archive``), phase 1 (the card's identity and the kernels' build), then
each named phase function of its ``chip_smoke.py`` in order (default:
``phase_tp phase_sp_ep phase_pp phase_mnist_bert``, the phases that share
worlds of two ranks), and prints one line: each phase's seconds, their sum
and the total with phase 1. A failed check is printed and counted, not
fatal, so that the timing completes. Run it once a tree in turns (the
other tree, this one, this one, the other) in one call on the card.
"""

from __future__ import annotations

import os
import sys
import time

DEFAULT = ("phase_tp", "phase_sp_ep", "phase_pp", "phase_mnist_bert")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    tree = os.path.abspath(argv[0])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    fails = []
    cs._fail = lambda m: (fails.append(m), print(f"[chip_smoke] FAIL: {m[:2000]}", flush=True))
    t0 = time.perf_counter()
    cs.phase_identity_and_build()
    kernels = [{"name": n} for n in fa.launch_counts()]
    times = {}
    for name in argv[1:] or DEFAULT:
        t = time.perf_counter()
        getattr(cs, name)(kernels)
        times[name] = round(time.perf_counter() - t, 1)
    print(f"[chip_phases] {tree}: {times}, sum {round(sum(times.values()), 1)} s, with phase 1 "
          f"{round(time.perf_counter() - t0, 1)} s, failed checks {len(fails)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
