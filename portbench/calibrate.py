"""The readings that a cell's limits are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... [--control 3] [--faults 3]

For each seed, in one process: the program's readings over the checked
steps (as a run takes them), the f32 reference's, and the comparison's
numbers. On the first ``--control`` seeds also the control, the reference
computed in fp8 in the program's place; on the first ``--faults`` seeds the
program with a planted fault: ``half_batch`` (the step trains on half the
batch, the mean taken over the rest: the first half of the rows, or of the
positions of a single row) and ``frozen`` (the step computes the loss and
returns the state unchanged). The last line of standard output is one JSON
object: every seed's numbers, and per number the program's largest reading
(the lower reading) and the control's and each fault's smallest.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, harness, reference, weights


def half_batch(step):
    def broken(tokens):
        B, S = tokens.shape
        return step(tokens[: B // 2] if B > 1 else tokens[:, : S // 2])
    return broken


def frozen(prog: harness.PortTrainer):
    from pytorch_operator_tpu_torch.workloads import trainer

    loss_fn = trainer.make_lm_loss_fn(prog.model)

    def broken(tokens):
        with torch.no_grad():
            return loss_fn(tokens).detach()
    return broken


FAULTS = {"half_batch": lambda prog: half_batch(prog.step), "frozen": frozen}


def program_readings(cell: harness.Cell, seed: int, device, fault=None) -> reference.Readings:
    """The program's readings over the cell's checked steps, optionally with
    a planted fault; the program is freed before returning."""
    prog = harness.PortTrainer(cell.config, cell.mix, seed, device)
    if fault is not None:
        prog.step = FAULTS[fault](prog)
    pool = weights.tokens(cell.config, cell.mix, seed, device)
    out = harness.check_steps(prog, pool, cell.limits["steps"], cell.config, seed).readings()
    del prog, pool
    harness.free_memory(device)
    return out


def calibrate(cell: harness.Cell, seeds, device, n_control: int, n_faults: int, log=print) -> dict:
    k = cell.limits["steps"]
    rows = []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        prog = program_readings(cell, seed, device)
        faults = {f: program_readings(cell, seed, device, f) for f in FAULTS} if i < n_faults else {}
        batches = list(weights.tokens(cell.config, cell.mix, seed, device)[:k])
        ref = reference.train_readings(cell.config, batches, seed)
        row = {"seed": seed, "program": check.numbers(prog, ref),
               "faults": {f: check.numbers(r, ref) for f, r in faults.items()}}
        if i < n_control:
            row["control"] = check.numbers(reference.train_readings(cell.config, batches, seed, "fp8"), ref)
        row["seconds"] = time.perf_counter() - t
        log(json.dumps(row))
        rows.append(row)
    names = list(rows[0]["program"])
    summary = {"lower": {n: max(r["program"][n] for r in rows) for n in names}}
    kinds = ["control"] + [f"faults.{f}" for f in FAULTS]
    for kind in kinds:
        got = [r.get(kind) if "." not in kind else r["faults"].get(kind.split(".")[1]) for r in rows]
        got = [g for g in got if g]
        if got:
            summary[kind] = {n: min(g[n] for g in got) for n in names}
    return {"workload": cell.name, "steps": k, "rows": rows, "summary": summary}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration runs on a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    out = calibrate(cell, args.seeds, torch.device("cuda", 0), args.control, args.faults,
                    log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
