"""Shared-memory ring transport: the serve plane's memory-speed tier.

The port's copy of the engine side of ``pytorch_operator_tpu/serving/
shmring.py``: :class:`ShmRing`, :class:`EngineRingPort` and
:class:`EngineTransport`, with the same file layout, header and record
encoding, so the router's ``RouterRingPort`` (JAX package, run by the
supervisor) and a port engine share one ring pair. The router's half and
``prearm_rings`` stay in the JAX package.

The file spool (serving/spool.py) is the DURABLE serve transport —
rename-atomic, crash-recoverable, cross-host over a shared filesystem —
but every request costs file creates, renames and directory scans. For
a router and an engine on the SAME host, this module provides the fast
tier: a pair of mmap'd single-producer/single-consumer byte rings per
replica (requests router→engine, responses engine→router), sequence-
number framed, with the file spool kept as the automatic spill path
(ring full, peer not attached, or cross-host configuration).

Correctness pins, in order of importance:

- **Exactly-once is NOT the ring's job.** The ring is at-most-once
  delivery of bytes; the serve plane's exactly-once contract is
  enforced where it always was — the router's ``Spool.respond_once``
  (link-EEXIST, in the supervisor) at the front-spool publication
  point, and router re-route on replica death. A ring record lost to
  a crashed peer is re-driven through the file path; a ring record
  served twice (engine restart replaying unconsumed entries) loses the
  publication race. Chaos cells pin both.
- **Single writer per cursor, by construction.** The producer is the
  only writer of ``head`` (and the record bytes it fences); the
  consumer is the only writer of ``tail``/``consumed``. Every record
  carries its own crc32 and a dense sequence number; the consumer
  stops at the first frame whose seq is not the next expected — a
  torn or in-flight write is simply "not published yet".
- **No deadline math.** The ring has no clocks at all; staleness and
  retry live in the router's existing (monotonic) schedules.

Layout of a ring file (``req.ring`` / ``resp.ring`` in the replica's
spool directory, created by the ROUTER via tmp+rename so the engine
never maps a half-initialized file):

    header page (4096 B):
        0:8    magic  b"TPUJRING"
        8:12   version u32
        16:24  capacity u64     data-region bytes (multiple of 8)
        24:32  head u64         producer cursor, MONOTONIC byte count
        32:40  tail u64         consumer cursor, MONOTONIC byte count
        40:48  seq u64          producer: records published
        48:56  consumed u64     consumer: records consumed
    data region (capacity B), records never split across the wrap:
        [u32 0x52454331][u32 len][u64 seq][u32 crc32][u32 pad] payload
        (padded to 8 B); a [u32 0x57524150] marker at the cursor means
        "skip to the ring start".
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import time
import zlib
from pathlib import Path
from typing import List, Optional, Tuple

from ..backoff import Backoff
from ..obs.trace import serve_span, tracer as _span_tracer

MAGIC = b"TPUJRING"
VERSION = 1
HEADER_BYTES = 4096
REC_MAGIC = 0x52454331  # "REC1"
WRAP_MAGIC = 0x57524150  # "WRAP"
REC_HEADER = struct.Struct("<IIQII")  # magic, len, seq, crc, pad
_U64 = struct.Struct("<Q")

# Default data-region size per ring: 1 MiB holds thousands of typical
# request records — a full ring means the engine is far behind, and
# the right answer is the durable spill path, not a bigger ring.
RING_BYTES = 1 << 20

REQ_RING = "req.ring"
RESP_RING = "resp.ring"

# Engine-side spool-scan gate: ring polls are mmap reads (free), but a
# file-spool claim is a real scandir. With a ring attached, idle file
# scans back off toward the cap; any file hit — or no ring at all —
# resets to every-poll scanning (the file path stays first-class).
SPOOL_SCAN_BACKOFF = Backoff(base_s=0.005, cap_s=0.25, factor=2.0,
                             jitter=0.1)

_OFF_CAPACITY = 16
_OFF_HEAD = 24
_OFF_TAIL = 32
_OFF_SEQ = 40
_OFF_CONSUMED = 48


def _align8(n: int) -> int:
    return (n + 7) & ~7


class ShmRing:
    """One SPSC byte ring over an mmap'd file. Exactly one process
    calls :meth:`push` (the producer) and exactly one calls
    :meth:`pop` (the consumer); the header cursors are single-writer
    by that construction."""

    def __init__(self, path: Path, mm: mmap.mmap, fh):
        self.path = Path(path)
        self._mm = mm
        self._fh = fh
        self.capacity = _U64.unpack_from(mm, _OFF_CAPACITY)[0]
        # Transport accounting (mirrored into RouterIOCounters).
        self.pushes = 0
        self.push_full = 0
        self.pops = 0
        self.torn = 0

    # ---- lifecycle ----

    @classmethod
    def create(cls, path: Path | str, capacity: int = RING_BYTES) -> "ShmRing":
        """Create (or atomically replace) the ring file: the full file
        is initialized in a tmp and renamed into place, so an attaching
        peer can never map a half-built ring."""
        path = Path(path)
        capacity = max(4096, _align8(int(capacity)))
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        with open(tmp, "wb") as fh:
            fh.truncate(HEADER_BYTES + capacity)
            fh.seek(0)
            fh.write(MAGIC)
            fh.write(struct.pack("<I", VERSION))
            fh.seek(_OFF_CAPACITY)
            fh.write(_U64.pack(capacity))
            fh.flush()
            os.fsync(fh.fileno())
        os.rename(tmp, path)
        return cls.attach(path)

    @classmethod
    def attach(cls, path: Path | str) -> "ShmRing":
        """Map an existing ring file; raises ``OSError`` when absent
        and ``ValueError`` on a foreign or version-skewed file."""
        path = Path(path)
        fh = open(path, "r+b")
        try:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_WRITE)
        except (OSError, ValueError):
            fh.close()
            raise
        if mm[0:8] != MAGIC:
            mm.close()
            fh.close()
            raise ValueError(f"{path}: not a tpujob ring file")
        ver = struct.unpack_from("<I", mm, 8)[0]
        if ver != VERSION:
            mm.close()
            fh.close()
            raise ValueError(f"{path}: ring version {ver} != {VERSION}")
        return cls(path, mm, fh)

    def close(self) -> None:
        try:
            self._mm.close()
        except (OSError, ValueError):
            pass
        try:
            self._fh.close()
        except OSError:
            pass

    # ---- cursors ----

    def _read_u64(self, off: int) -> int:
        return _U64.unpack_from(self._mm, off)[0]

    def _write_u64(self, off: int, val: int) -> None:
        _U64.pack_into(self._mm, off, val)

    @property
    def used(self) -> int:
        return self._read_u64(_OFF_HEAD) - self._read_u64(_OFF_TAIL)

    @property
    def free(self) -> int:
        return self.capacity - self.used

    # ---- producer ----

    def push(self, payload: bytes) -> bool:
        """Publish one record; returns False (ring full) when it does
        not fit — the caller spills to the file path. Payload bytes and
        the record header are written BEFORE the head cursor advance
        that publishes them (the consumer never reads past head)."""
        mm = self._mm
        need = _align8(REC_HEADER.size + len(payload))
        head = self._read_u64(_OFF_HEAD)
        tail = self._read_u64(_OFF_TAIL)
        free = self.capacity - (head - tail)
        offset = head % self.capacity
        contig = self.capacity - offset
        if contig < need:
            # Never split a record: burn the tail of the ring with a
            # wrap marker and start at 0 (costs contig bytes of budget).
            if contig + need > free:
                self.push_full += 1
                return False
            struct.pack_into("<I", mm, HEADER_BYTES + offset, WRAP_MAGIC)
            head += contig
            offset = 0
        elif need > free:
            self.push_full += 1
            return False
        seq = self._read_u64(_OFF_SEQ)
        REC_HEADER.pack_into(
            mm,
            HEADER_BYTES + offset,
            REC_MAGIC,
            len(payload),
            seq,
            zlib.crc32(payload) & 0xFFFFFFFF,
            0,
        )
        mm[
            HEADER_BYTES + offset + REC_HEADER.size :
            HEADER_BYTES + offset + REC_HEADER.size + len(payload)
        ] = payload
        # Publication fence: data first, then seq, then head.
        self._write_u64(_OFF_SEQ, seq + 1)
        self._write_u64(_OFF_HEAD, head + need)
        self.pushes += 1
        return True

    # ---- consumer ----

    def pop(self, max_n: int = 0) -> List[bytes]:
        """Consume up to ``max_n`` records (0 = all published). Stops
        at the first frame whose sequence number is not the next
        expected — an in-flight producer write is simply not published
        yet. A crc-failed frame (true corruption: the producer never
        advances head over an unwritten record) is counted in ``torn``
        and skipped."""
        mm = self._mm
        out: List[bytes] = []
        head = self._read_u64(_OFF_HEAD)
        tail = self._read_u64(_OFF_TAIL)
        consumed = self._read_u64(_OFF_CONSUMED)
        while tail < head and (max_n <= 0 or len(out) < max_n):
            offset = tail % self.capacity
            contig = self.capacity - offset
            if contig < REC_HEADER.size:
                tail += contig
                continue
            magic = struct.unpack_from("<I", mm, HEADER_BYTES + offset)[0]
            if magic == WRAP_MAGIC:
                tail += contig
                continue
            if magic != REC_MAGIC:
                # Garbage where a record header should be: resync by
                # declaring everything up to head consumed (the crc/seq
                # framing means this only happens on real corruption).
                self.torn += 1
                tail = head
                break
            _, ln, seq, crc, _ = REC_HEADER.unpack_from(
                mm, HEADER_BYTES + offset
            )
            if ln > contig - REC_HEADER.size:
                self.torn += 1
                tail = head
                break
            if seq != consumed:
                break  # not the next record — unpublished or replayed
            start = HEADER_BYTES + offset + REC_HEADER.size
            payload = bytes(mm[start : start + ln])
            tail += _align8(REC_HEADER.size + ln)
            consumed += 1
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                self.torn += 1
                continue
            out.append(payload)
        self._write_u64(_OFF_CONSUMED, consumed)
        self._write_u64(_OFF_TAIL, tail)
        self.pops += len(out)
        return out


def _encode(rec: dict) -> bytes:
    return json.dumps(rec, separators=(",", ":")).encode()


def _decode_many(payloads: List[bytes]) -> List[dict]:
    out = []
    for p in payloads:
        try:
            rec = json.loads(p)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


class EngineRingPort:
    """The engine's half: request consumer, response producer.
    :meth:`attach` returns None until the router has created the ring
    pair — the engine polls it from its idle loop (two path checks,
    no syscalls once attached)."""

    def __init__(self, req: ShmRing, resp: ShmRing):
        self.req = req
        self.resp = resp

    @classmethod
    def attach(cls, spool_root: Path | str) -> Optional["EngineRingPort"]:
        root = Path(spool_root)
        try:
            req = ShmRing.attach(root / REQ_RING)
        except (OSError, ValueError):
            return None
        try:
            resp = ShmRing.attach(root / RESP_RING)
        except (OSError, ValueError):
            req.close()
            return None
        return cls(req, resp)

    def recv(self, max_n: int = 0) -> List[dict]:
        return _decode_many(self.req.pop(max_n))

    def send(self, rec: dict) -> bool:
        return self.resp.push(_encode(rec))

    def close(self) -> None:
        self.req.close()
        self.resp.close()


class EngineTransport:
    """What a serving replica reads requests from and writes responses
    to: the file spool always (durable tier), plus the ring pair when
    the job's transport is ``shmring`` and the router has created the
    rings (memory tier). The same transport semantics as the JAX
    package's serve workloads.

    Fallback ladder, engine side:

    - requests: drain the ring first (memory-speed), then the file
      spool (spilled or cross-host traffic) — both feed one admission
      queue, oldest-batch-first within each tier;
    - responses: try the ring; on full (or no ring) write the response
      FILE — the router collects both sides every pass. A response is
      written to exactly one tier; the front-spool ``respond_once`` is
      the exactly-once point either way.
    """

    def __init__(self, spool_dir: Path | str, transport: str = "spool"):
        from .spool import Spool

        self.spool = Spool(spool_dir)
        self.transport = transport
        self._ring: Optional[EngineRingPort] = None
        self.ring_recvs = 0
        self.ring_sends = 0
        self.ring_send_spills = 0
        self._spool_misses = 0
        self._next_spool_scan = 0.0  # monotonic gate

    @property
    def ring_attached(self) -> bool:
        return self._ring is not None

    def _maybe_attach(self) -> None:
        if self.transport != "shmring" or self._ring is not None:
            return
        self._ring = EngineRingPort.attach(self.spool.root)

    def recover(self) -> int:
        """Engine-startup recovery: file-spool claims a previous life
        left behind go back to requests/ (ring records a previous life
        consumed-but-dropped are the router's to re-drive on death)."""
        return self.spool.recover_claimed()

    def poll_requests(self, limit: int) -> Tuple[List[dict], int]:
        """Up to ``limit`` new requests and the count that came over
        the ring (telemetry)."""
        if limit <= 0:
            return [], 0
        self._maybe_attach()
        out: List[dict] = []
        from_ring = 0
        if self._ring is not None:
            ring_recs = self._ring.recv(limit)
            from_ring = len(ring_recs)
            self.ring_recvs += from_ring
            out.extend(ring_recs)
        if len(out) < limit and (
            self._ring is None
            # invariant: clock-discipline — the scan gate is an
            # in-process deadline, so it lives on the monotonic axis.
            or time.monotonic() >= self._next_spool_scan
        ):
            recs = self.spool.claim(limit - len(out))
            if recs or self._ring is None:
                self._spool_misses = 0
                self._next_spool_scan = 0.0
            else:
                self._spool_misses += 1
                self._next_spool_scan = (
                    time.monotonic()
                    + SPOOL_SCAN_BACKOFF.delay(self._spool_misses - 1)
                )
            out.extend(recs)
        if out and _span_tracer() is not None:
            # Transit hop: the router stamped tctx["tx"] (wall clock —
            # the only axis two processes share) just before handing
            # the record to the ring or the spill file; receive time
            # minus that stamp is the transit latency of whichever
            # tier carried it.
            now = time.time()
            for i, rec in enumerate(out):
                tx = (rec.get("tctx") or {}).get("tx")
                if tx is not None:
                    serve_span(
                        "ring_transit" if i < from_ring else "spool_transit",
                        float(tx),
                        max(0.0, now - float(tx)),
                        rid=rec.get("id", "?"),
                    )
        return out, from_ring

    def respond(self, rid: str, record: dict) -> None:
        """Publish one response through the fastest available tier."""
        if self._ring is not None and self._ring.send(record):
            self.ring_sends += 1
            # The file-spool claim (if this request came over the file
            # path) still needs clearing so recovery never replays it.
            self.spool._release_claim(rid)
            return
        if self._ring is not None:
            self.ring_send_spills += 1
        self.spool.respond(rid, record)

    def pending_count(self) -> int:
        n = self.spool.pending_count()
        if self._ring is not None:
            n += self._ring.req.used and 1 or 0
        return n

    def close(self) -> None:
        if self._ring is not None:
            self._ring.close()
            self._ring = None
