"""Profile report: where the time goes in a ``torch.profiler`` trace — the
port of ``pytorch_operator_tpu/profiling.py``.

A workload run with ``--profile-dir`` writes the Chrome-trace JSON that
``torch.profiler`` exports (``workloads/trainer.maybe_profile``); this module
reads it without TensorBoard and prints the per-step busy time, op-category
totals and the top individual ops, with the JAX tool's report keys.

    python -m pytorch_operator_tpu_torch.workloads.llama_train ... --profile-dir /tmp/prof
    python -m pytorch_operator_tpu_torch.profiling /tmp/prof [--device cuda] [--top 12] [--json]

The trace's events fall on planes, the counterpart of the xplane's:

- ``cuda:<n>``: the kernels, copies and memsets of card ``n``, one line per
  stream; its steps, the xplane's "Steps" line, start where the profiled
  loop's ``record_function("step")`` ranges start on the card (the
  profiler's ``gpu_user_annotation``; the host's ranges where a trace has
  none) and run to the next step's start, the last to the plane's last
  event. (The projected range itself ends with the last kernel the main
  thread launched in it, before the backward that autograd's device thread
  launches.)
- ``cpu``: the host's events (ATen ops, CUDA runtime calls), one line per
  thread; its steps are the host-side ``step`` ranges.

Each event is charged its self time (its duration less the events nested
in it on its line), so the busy total is a partition of the trace, not a
double count of nested host ops.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from collections import defaultdict
from pathlib import Path
from typing import Optional

_US = 1e-6
# Event categories of the card's work, and of its projected step ranges.
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
DEVICE_MARKER_CAT = "gpu_user_annotation"
STEP_MARKER = "step"


def find_trace(profile_dir) -> Path:
    """The newest ``*.pt.trace.json`` under a ``--profile-dir`` tree."""
    paths = sorted(Path(profile_dir).rglob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {profile_dir}")
    return paths[-1]


def _category(name: str) -> str:
    """A kernel's family (``void at::native::foo<...>(...)`` → ``at::native::foo``,
    ``Memcpy HtoD (Pageable -> Device)`` → ``Memcpy HtoD``), with a trailing
    serial after a separator (``ProfilerStep#3``) stripped as the JAX tool
    strips HLO serials."""
    base = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    base = re.split(r"[<(]", base, maxsplit=1)[0].strip() or name
    return re.sub(r"[.\-#]\d+$", "", base) or base


def _aggregate_self_times(events, by_cat, by_op) -> float:
    """Charge each event of one line its self time into the aggregates;
    returns the line's busy seconds. An interval stack over start-sorted
    events (longest first at ties) recovers the nesting."""
    busy = 0.0
    stack: list = []  # [end, name, start, child]

    def pop(start) -> None:
        nonlocal busy
        while stack and (start is None or stack[-1][0] <= start):
            end, name, st, child = stack.pop()
            dur = end - st
            if stack:
                stack[-1][3] += dur
            dt = (dur - child) * _US
            busy += dt
            by_cat[_category(name)] += dt
            by_op[name] += dt

    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        pop(e["ts"])
        stack.append([e["ts"] + e["dur"], e["name"], e["ts"], 0.0])
    pop(None)
    return busy


def _planes(trace: dict) -> dict:
    """``{plane: {"lines": {line: [events]}, "steps": [(start, duration) µs]}}``."""
    planes: dict = defaultdict(lambda: {"lines": defaultdict(list), "steps": []})
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e or "ts" not in e:
            continue
        cat = e.get("cat", "")
        if cat == "Trace":  # the profiler's own whole-session range
            continue
        ev = {"name": str(e.get("name", "")), "ts": float(e["ts"]), "dur": float(e["dur"])}
        args = e.get("args") or {}
        if cat in DEVICE_CATS or cat == DEVICE_MARKER_CAT:
            plane = planes[f"cuda:{args.get('device', e.get('pid'))}"]
            if cat == DEVICE_MARKER_CAT:
                if ev["name"] == STEP_MARKER:
                    plane["steps"].append((ev["ts"], ev["dur"]))
                continue
            plane["lines"][f"stream {args.get('stream', e.get('tid'))}"].append(ev)
        else:
            plane = planes["cpu"]
            if cat == "user_annotation" and ev["name"] == STEP_MARKER:
                plane["steps"].append((ev["ts"], ev["dur"]))
                continue
            plane["lines"][f"thread {e.get('tid')}"].append(ev)
    return planes


def device_report(profile_dir, device_substr: str = "cuda") -> Optional[dict]:
    """The breakdown of the first plane whose name contains
    ``device_substr`` (``cuda`` for the card, ``cpu`` for the host), as a
    dict with the JAX tool's keys: ``device``, ``steps``, ``mean_step_s``,
    ``span_s``, ``busy_s``, ``busy_frac_of_steps`` (one line only),
    ``categories`` and ``top_ops`` (seconds a step, share of busy). None when
    the trace has no such plane (a CPU run asked for ``cuda``)."""
    trace = json.loads(find_trace(profile_dir).read_text())
    planes = _planes(trace)
    name = next((n for n in sorted(planes) if device_substr in n and planes[n]["lines"]), None)
    if name is None:
        return None
    plane = planes[name]
    report: dict = {"device": name}
    steps = sorted(plane["steps"] or planes["cpu"]["steps"])
    if name != "cpu" and steps:
        # A device step runs from its start to the next step's start, the
        # last one to the plane's last event.
        end = max(e["ts"] + e["dur"] for evs in plane["lines"].values() for e in evs)
        starts = [t for t, _ in steps] + [end]
        steps = [(t, max(nxt - t, 0.0)) for t, nxt in zip(starts, starts[1:])]
    if steps:
        durs = [d * _US for _, d in steps]
        report["steps"] = len(durs)
        report["mean_step_s"] = sum(durs) / len(durs)
        report["span_s"] = sum(durs)
    by_cat: dict = defaultdict(float)
    by_op: dict = defaultdict(float)
    busy = sum(_aggregate_self_times(evs, by_cat, by_op) for evs in plane["lines"].values())
    if busy <= 0:
        return report
    report["busy_s"] = busy
    # A utilization only for one line: N concurrent streams or threads
    # summed against the step span would read past 100% and mean nothing.
    if len(plane["lines"]) == 1 and report.get("span_s", 0) > 0:
        report["busy_frac_of_steps"] = busy / report["span_s"]
    n = report.get("steps") or 1
    report["categories"] = sorted(
        ({"category": c, "s_per_step": t / n, "pct_of_busy": 100 * t / busy} for c, t in by_cat.items()),
        key=lambda r: -r["s_per_step"],
    )
    report["top_ops"] = sorted(
        ({"op": o, "s_per_step": t / n, "pct_of_busy": 100 * t / busy} for o, t in by_op.items()),
        key=lambda r: -r["s_per_step"],
    )
    return report


def format_report(report: dict, top: int = 12) -> str:
    out = [f"device: {report['device']}"]
    if "steps" in report:
        out.append(f"steps: {report['steps']}  mean {report['mean_step_s'] * 1e3:.2f} ms/step")
    if "busy_s" in report:
        n = report.get("steps") or 1
        line = f"device busy: {report['busy_s'] / n * 1e3:.2f} ms/step"
        if "busy_frac_of_steps" in report:
            line += f" ({100 * report['busy_frac_of_steps']:.1f}% of step span)"
        out.append(line)
    if report.get("categories"):
        out.append("\nby op category (ms/step, % of busy):")
        for r in report["categories"][:top]:
            out.append(f"  {r['s_per_step'] * 1e3:8.2f}  {r['pct_of_busy']:5.1f}%  {r['category'][:120]}")
    if report.get("top_ops"):
        out.append(f"\ntop {top} ops (ms/step, % of busy):")
        for r in report["top_ops"][:top]:
            out.append(f"  {r['s_per_step'] * 1e3:8.2f}  {r['pct_of_busy']:5.1f}%  {r['op'][:120]}")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("profile_dir", help="the --profile-dir a workload wrote")
    p.add_argument("--device", default="cuda", help="plane substring: cuda (the card) or cpu")
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--json", action="store_true", dest="as_json")
    args = p.parse_args(argv)
    try:
        report = device_report(args.profile_dir, args.device)
    except (OSError, ValueError) as e:  # no trace; unreadable or truncated JSON
        print(f"error: {e}", file=sys.stderr)
        return 1
    if report is None:
        print(f"error: no '{args.device}' plane in the trace (try --device cpu)", file=sys.stderr)
        return 1
    if args.as_json:
        report["top_ops"] = report.get("top_ops", [])[: args.top]
        print(json.dumps(report, indent=2))
    else:
        print(format_report(report, args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
