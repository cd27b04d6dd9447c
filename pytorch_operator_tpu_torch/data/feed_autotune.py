"""Depth autotuning for the device feed — the port's copy of
``pytorch_operator_tpu/data/feed_autotune.py`` (pure decision logic: no
threads, no clock, no framework).

A static prefetch depth is right for a producer that is uniformly faster
than the step and wrong the moment it is bursty: a two-slot buffer drains in
two steps and every burst lands on the step loop as a stall. Each slot pins a
batch of device memory, so the depth is not raised everywhere either:
:class:`FeedAutotuner` grows it when the step loop measurably stalls and
gives the memory back after sustained headroom.

- **grow fast**: one observed stall at or above ``grow_stall_ms`` doubles the
  depth;
- **shrink slow**: only after ``shrink_patience`` consecutive stall-free
  observations does the depth step down by one;
- **bounded**: the depth never leaves ``[floor, depth_max]``
  (``spec.data_plane.prefetch_depth_max``, the device-memory budget).

``DevicePrefetcher`` (``data/device_prefetch.py``) feeds it the time each
``get()`` waited and applies the depth it returns.
"""

from __future__ import annotations

# One observed stall >= this fires a grow. 1 ms is real money on a
# multi-ms step and safely above timer noise on the queue hand-off.
DEFAULT_GROW_STALL_MS = 1.0
# Stall-free gets before ONE depth step down. At a 10 ms step this is
# ~0.3 s of sustained headroom per reclaimed slot.
DEFAULT_SHRINK_PATIENCE = 32


class FeedAutotuner:
    """Grow-fast / shrink-slow device-feed depth controller.

    ``observe(stall_ms)`` feeds one consumer-side measurement (the time
    the step loop waited in ``get()``) and returns the depth to use from
    now on. ``warmup`` initial observations are ignored entirely: the
    very first gets ALWAYS wait (the pipe is filling) and must not read
    as a stalling producer.
    """

    def __init__(
        self,
        depth_max: int,
        *,
        initial: int = 2,
        floor: int = 1,
        grow_stall_ms: float = DEFAULT_GROW_STALL_MS,
        shrink_patience: int = DEFAULT_SHRINK_PATIENCE,
        warmup: int = 4,
    ):
        self.floor = max(1, int(floor))
        self.depth_max = max(self.floor, int(depth_max))
        self.depth = min(max(int(initial), self.floor), self.depth_max)
        self.grow_stall_ms = float(grow_stall_ms)
        self.shrink_patience = max(1, int(shrink_patience))
        self.warmup = max(0, int(warmup))
        self._seen = 0
        self._quiet = 0  # consecutive stall-free observations
        self.grows = 0
        self.shrinks = 0

    def observe(self, stall_ms: float) -> int:
        """One consumer-side stall sample -> the depth to use next."""
        self._seen += 1
        if self._seen <= self.warmup:
            return self.depth
        if stall_ms >= self.grow_stall_ms:
            self._quiet = 0
            if self.depth < self.depth_max:
                # Double toward the cap: a stalling feed needs headroom
                # NOW, and a linear walk pays one burst per increment.
                self.depth = min(self.depth_max, self.depth * 2)
                self.grows += 1
        else:
            self._quiet += 1
            if self._quiet >= self.shrink_patience and self.depth > self.floor:
                # One slot at a time: reclaiming memory is never urgent,
                # and a halving here would surrender the buffer a bursty
                # producer refills only between bursts.
                self.depth -= 1
                self.shrinks += 1
                self._quiet = 0
        return self.depth
