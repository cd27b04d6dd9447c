"""Jittered exponential backoff — the port's copy of ``Backoff`` and
``retry_call`` from ``pytorch_operator_tpu/backoff.py``: the schedule the
spool's response wait and the ring transport's spool-scan gate poll on, the
checkpoint manager's retry of transient write failures, and the rendezvous
join's retry of a coordinator that is not listening yet.

Exponential growth, a cap, and DETERMINISTIC jitter derived by hashing
(seed, attempt), never from a PRNG or the clock, so both packages sleep the
identical schedule.
"""

from __future__ import annotations

import hashlib
import math
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


@dataclass(frozen=True)
class Backoff:
    """attempt (0-based) -> delay seconds: ``base * factor^attempt``,
    capped, then jittered by ±``jitter`` fraction deterministically."""

    base_s: float = 0.1
    cap_s: float = 30.0
    factor: float = 2.0
    jitter: float = 0.25
    seed: int = 0

    def delay(self, attempt: int) -> float:
        attempt = max(0, attempt)
        exp = attempt
        if self.factor > 1.0 and self.base_s > 0:
            # Clamp the exponent at the cap crossover: past it the
            # un-jittered delay is cap_s regardless, and an unbounded
            # attempt counter (an idle poll loop running for hours)
            # would overflow float pow. Jitter still hashes the REAL
            # attempt, so capped delays stay decorrelated.
            limit = math.log(
                max(self.cap_s, self.base_s) / self.base_s
            ) / math.log(self.factor)
            exp = min(exp, int(limit) + 1)
        d = min(self.cap_s, self.base_s * self.factor ** exp)
        if self.jitter:
            h = hashlib.blake2b(
                f"{self.seed}:{attempt}".encode(), digest_size=8
            ).digest()
            frac = int.from_bytes(h, "big") / 2**64  # [0, 1)
            d *= 1.0 + self.jitter * (2.0 * frac - 1.0)
        return max(0.0, d)

    def delays(self, attempts: int):
        return [self.delay(a) for a in range(attempts)]


def retry_call(
    fn: Callable,
    *,
    backoff: Backoff,
    attempts: Optional[int] = None,
    timeout_s: Optional[float] = None,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    on_retry: Optional[Callable[[BaseException, int], None]] = None,
):
    """Call ``fn`` until it returns, retrying ``retry_on`` failures on the
    backoff schedule. Stops at ``attempts`` calls and/or when the next sleep
    would cross ``timeout_s`` (from the first call), whichever comes first,
    then re-raises the last failure. ``on_retry(exc, attempt)`` runs before
    each sleep (e.g. removing a partly written checkpoint step so that the
    retry starts clean)."""
    if attempts is None and timeout_s is None:
        raise ValueError("retry_call needs attempts and/or timeout_s")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            if attempts is not None and attempt >= attempts:
                raise
            d = backoff.delay(attempt - 1)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise
                d = min(d, remaining)
            if on_retry is not None:
                on_retry(e, attempt)
            time.sleep(d)
