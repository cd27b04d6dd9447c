"""Timing one call alone on the card with CUDA events."""

from __future__ import annotations

import math

import torch

# Launches of a timed loop span at least this long, after the warm-up calls.
MIN_SECONDS = 0.5
WARMUP = 2


def seconds_per_call(fn, *, min_seconds: float = MIN_SECONDS, warmup: int = WARMUP) -> float:
    """The mean seconds of ``fn()`` over enough back-to-back calls to span
    ``min_seconds``, timed by CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = start.elapsed_time(end) / 1e3
    n = max(1, math.ceil(min_seconds / max(once, 1e-6)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n
