"""BERT-base in one process, as ``chip_smoke.py``'s phase 16(e) runs it
(bench.py's recipe: B64 x S128, 3 warmup steps), on another checkout of the
repo and on this one in turns:

    python3 tools/bert_ab.py OTHER_TREE [--rounds 2] [--steps 60]

Each round runs ``bert_fsdp.run`` in a fresh process in OTHER_TREE, in this
checkout, in this checkout again and in OTHER_TREE again, on the card.
Prints the card's name and power limit, each run's step time, rate, peak
memory and first losses, whether every run's losses are equal bit for bit,
and each tree's step times sorted with their median. Exits 1 if a run
fails; it reports, it does not judge a gain.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("other", help="another checkout of the repo (e.g. the parent commit's, unpacked)")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--steps", type=int, default=60)
    args = p.parse_args(argv)
    run = dict(bert_base=True, batch_size=64, seq_len=128, steps=args.steps, warmup=3)
    code = ("import json; from pytorch_operator_tpu_torch.workloads import bert_fsdp; "
            f"r = bert_fsdp.run(device='cuda', log=lambda m: None, **{run!r}); "
            "print('RESULT', json.dumps({k: r[k] for k in ('value', 'step_s', 'losses', 'peak_mem_bytes')}))")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    trees = {"other": Path(args.other).resolve(), "this": HERE}
    out = {"other": [], "this": []}
    for tag in ["other", "this", "this", "other"] * args.rounds:
        proc = subprocess.run([sys.executable, "-c", code], cwd=trees[tag], capture_output=True, text=True)
        line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
        if proc.returncode or not line:
            print(f"{tag}: exit {proc.returncode}\n{proc.stderr[-3000:]}", flush=True)
            return 1
        r = json.loads(line[0][len("RESULT "):])
        out[tag].append(r)
        print(f"{tag}: step {r['step_s'] * 1e3:.3f} ms, {r['value']} sequences/s, peak {r['peak_mem_bytes']} B, "
              f"losses {[round(x, 5) for x in r['losses'][:4]]}", flush=True)
    first = out["other"][0]["losses"]
    print("losses equal bit for bit in every run:", all(r["losses"] == first for rs in out.values() for r in rs))
    for tag, rs in out.items():
        ms = sorted(r["step_s"] * 1e3 for r in rs)
        print(f"{tag} ({trees[tag]}): step ms {[round(x, 3) for x in ms]}, median {statistics.median(ms):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
