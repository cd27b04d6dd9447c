"""Reading a ``torch.profiler`` Chrome trace of the measured window.

The events are sorted onto planes as the port's ``profiling.py`` sorts them
(a copy of its ``_planes`` without the step markers: the card's kernels,
copies and memsets by device, the host's events by thread; the profiler's
own whole-session range left out). The window is the host range named by
the harness; on the card, the busy time is the union of the device events'
intervals inside it, and an idle gap is a stretch of it that no device
event covers. Each gap is charged to the host event that started last
among those running on any host thread when it opened: what the host was
doing while the card waited.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_US = 1e-6
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"})
TOP = 10


@dataclass
class TraceView:
    """The window as the trace saw it."""

    window_s: float
    busy_s: float  # averaged over the cards in the trace
    devices: int
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _planes(trace: dict) -> dict:
    """``{plane: {line: [events]}}``: planes ``cuda:<n>`` and ``cpu``."""
    planes: dict = defaultdict(lambda: defaultdict(list))
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e or "ts" not in e:
            continue
        cat = e.get("cat", "")
        if cat == "Trace":
            continue
        ev = {"name": str(e.get("name", "")), "ts": float(e["ts"]), "dur": float(e["dur"]), "cat": cat}
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            plane = planes[f"cuda:{args.get('device', e.get('pid'))}"]
            plane[f"stream {args.get('stream', e.get('tid'))}"].append(ev)
        else:
            planes["cpu"][f"thread {e.get('tid')}"].append(ev)
    return planes


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The merged ``[start, end)`` intervals, clipped to ``[lo, hi]``."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _host_at(events: List[dict], times: List[float]) -> List[Optional[dict]]:
    """The innermost event of one host thread running at each of ``times``
    (sorted)."""
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    starts = [e["ts"] for e in events]
    out = []
    stack: List[dict] = []
    i = 0
    for t in times:
        while i < len(events) and starts[i] <= t:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= events[i]["ts"]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def read(path, window_name: str) -> Optional[TraceView]:
    """The window named ``window_name`` in the trace at ``path``; None when
    the trace has no such range or no device plane."""
    with open(path) as f:
        trace = json.load(f)
    planes = _planes(trace)
    host = planes.get("cpu", {})
    win = None
    for line, evs in host.items():
        for e in evs:
            if e["cat"] == "user_annotation" and e["name"] == window_name:
                win = (line, e["ts"], e["ts"] + e["dur"])
    devices = [p for p in planes if p.startswith("cuda:")]
    if win is None or not devices:
        return None
    _, lo, hi = win
    busy = 0.0
    gaps: List[Tuple[float, float]] = []
    by_op: Dict[str, float] = defaultdict(float)
    for p in devices:
        evs = [e for es in planes[p].values() for e in es if e["ts"] < hi and e["ts"] + e["dur"] > lo]
        spans = _union([(e["ts"], e["ts"] + e["dur"]) for e in evs], lo, hi)
        busy += sum(e - s for s, e in spans)
        edges = [lo] + [x for s, e in spans for x in (s, e)] + [hi]
        gaps += [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        for e in evs:
            by_op[e["name"]] += (min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)) * _US
    gaps.sort()
    starts = [a for a, _ in gaps]
    at = [None] * len(gaps)
    for evs in host.values():
        evs = [e for e in evs if e["cat"] in HOST_CATS and e["name"] != window_name]
        for i, e in enumerate(_host_at(evs, starts)):
            if e is not None and (at[i] is None or e["ts"] > at[i]["ts"]):
                at[i] = e
    by_gap: Dict[str, float] = defaultdict(float)
    for (a, b), e in zip(gaps, at):
        by_gap[e["name"] if e else "(no host event)"] += (b - a) * _US
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
    return TraceView(
        window_s=(hi - lo) * _US,
        busy_s=busy * _US / len(devices),
        devices=len(devices),
        device_ops=top(by_op),
        idle_gaps=top(by_gap),
    )
