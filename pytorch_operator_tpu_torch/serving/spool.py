"""File-spool request/response transport for the serving engine.

The port's copy of the parts of ``pytorch_operator_tpu/serving/spool.py``
that an engine and a client use (client: ``submit``/``enqueue``/
``enqueue_batch``/``wait_response``; engine: ``claim``, ``recover_claimed``,
``respond``, ``pending_count``), with the batch framing
(:func:`encode_frames`/:func:`decode_frames`) byte for byte: the router in
the supervisor writes ``.jsonb`` batches with the JAX package's framing, and
a port engine claims them. The router's own half (``respond_once``,
``drain_responses``, ``cancel``, ``sweep_stale``) runs in the supervisor and
is not copied.

Reference analog: the reference exposes workloads through cluster
Services; this environment has no network, so the serving job's request
surface is a spool DIRECTORY (the same local-IPC substrate the
supervisor's store/progress layers ride). The protocol is the classic
maildir trick: writers create a temp file and ``rename`` it into place
— rename is atomic on POSIX, so the scanner never sees a torn file —
and the engine claims a request by renaming it out of ``requests/``,
so an in-flight request is never double-served. A crashed engine
leaves its claims in ``claimed/``; the serve workload calls
:meth:`Spool.recover_claimed` at startup to move them back into
``requests/`` (the supervisor's restart policy re-runs the job, and
the orphaned clients would otherwise wait out their timeouts).

Layout under the spool root:

    requests/<id>.json     submitted, unclaimed (one record)
    requests/b-<id>.jsonb  submitted, unclaimed (a BATCH of records)
    claimed/...            claimed by the engine (in flight)
    responses/<id>.json    completed (tokens + latency record)

Batched framing (the serve plane's syscall collapse): a ``.jsonb``
file carries MANY requests — one crc-guarded frame per line — written
with ONE temp file, ONE fsync, and ONE rename, and claimed with ONE
rename, so the per-request syscall count drops by the batch factor.
The frame format is torn-tolerant by construction: every complete
frame ends in a newline and carries its own crc32, so a reader of a
file some foreign writer tore mid-write (no tmp+rename discipline)
recovers every complete record and drops only the torn tail —
:func:`decode_frames` is the single decoder both sides use.
"""

from __future__ import annotations

import json
import os
import time
import uuid
import zlib
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from ..backoff import Backoff
from ..obs.trace import serve_span, tracer as _span_tracer

# Batch files: many frames per spool file. ``.recovered.jsonb`` marks a
# batch a crashed engine left in claimed/ and recover_claimed() moved
# back — ONLY those pay the per-record response-dedup check on
# re-claim (a record of the batch may have been answered before the
# crash; re-serving it would waste capacity and, without the router's
# exactly-once publication, risk a duplicate).
BATCH_SUFFIX = ".jsonb"
RECOVERED_MARK = ".recovered"

# Adaptive response-wait schedule: a client polling for a response
# that is still cooking backs off exponentially instead of burning a
# fixed-interval stat() loop (the shared backoff.py schedule — same
# discipline as rendezvous joins and checkpoint retries).
WAIT_BACKOFF = Backoff(base_s=0.002, cap_s=0.25, factor=1.7, jitter=0.1)


def encode_frames(recs: List[dict]) -> bytes:
    """Frame records for a batch file: one line per record,
    ``<crc32 of payload, 8 hex>:<payload json>\\n``. The crc covers the
    payload bytes, so a torn or bit-flipped line is detected without
    trusting json to fail."""
    out = []
    for rec in recs:
        payload = json.dumps(rec, separators=(",", ":")).encode()
        out.append(b"%08x:" % (zlib.crc32(payload) & 0xFFFFFFFF))
        out.append(payload)
        out.append(b"\n")
    return b"".join(out)


def decode_frames(data: bytes) -> Tuple[List[dict], int]:
    """Decode a batch file's frames; returns ``(records, torn)``.

    Torn-tolerant: a line without a trailing newline (the classic
    crash-mid-write shape), a crc mismatch, or unparseable json counts
    as torn and is SKIPPED — every complete frame before, between and
    after torn ones is recovered."""
    recs: List[dict] = []
    torn = 0
    end = len(data)
    pos = 0
    while pos < end:
        nl = data.find(b"\n", pos)
        if nl < 0:
            torn += 1  # torn tail: the writer died mid-line
            break
        line = data[pos:nl]
        pos = nl + 1
        if not line:
            continue
        if len(line) < 10 or line[8:9] != b":":
            torn += 1
            continue
        payload = line[9:]
        try:
            crc = int(line[:8], 16)
        except ValueError:
            torn += 1
            continue
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            torn += 1
            continue
        try:
            rec = json.loads(payload)
        except json.JSONDecodeError:
            torn += 1
            continue
        if isinstance(rec, dict):
            recs.append(rec)
        else:
            torn += 1
    return recs, torn


def make_request(
    *,
    prompt=None,
    prompt_len: Optional[int] = None,
    max_new_tokens: int = 64,
    request_id: Optional[str] = None,
) -> dict:
    """Build a request record (the :meth:`Spool.submit` payload shape).

    ``prompt`` is an explicit token-id list; ``prompt_len`` asks the
    engine to synthesize a deterministic prompt of that length (no
    tokenizer ships in this environment). Exactly one must be set.

    Every request carries a trace context frame field ``tctx`` —
    ``{"o": origin wall ts, "p": parent span id}`` — threaded verbatim
    through every hop (front spool → router lane → ring/spill →
    engine) so each process can emit its hop span against the SAME
    request identity. The parent span id is derived from the rid
    (crc32, 8 hex) rather than drawn fresh: a replayed record after a
    torn-batch recovery re-derives the identical id, so replay cannot
    fork a request's waterfall. With tracing disabled the field is a
    few bytes of dead weight per frame and nothing reads it."""
    if (prompt is None) == (prompt_len is None):
        raise ValueError("exactly one of prompt / prompt_len required")
    rid = request_id or uuid.uuid4().hex[:12]
    submit = time.time()
    return {
        "id": rid,
        "prompt": list(map(int, prompt)) if prompt is not None else None,
        "prompt_len": prompt_len,
        "max_new_tokens": int(max_new_tokens),
        "submit_time": submit,
        "tctx": {
            "o": round(submit, 6),
            "p": "%08x" % (zlib.crc32(rid.encode()) & 0xFFFFFFFF),
        },
    }


class Spool:
    def __init__(self, root: Path | str, create: bool = True):
        self.root = Path(root)
        self.requests = self.root / "requests"
        self.claimed = self.root / "claimed"
        self.responses = self.root / "responses"
        # Batch-claim bookkeeping: records claimed but not yet returned
        # (a batch bigger than the claim limit), and per-batch-file
        # outstanding rid sets (the claimed ``.jsonb`` is unlinked when
        # its last record is responded).
        self._carry: deque = deque()
        self._batch_pending: Dict[Path, Set[str]] = {}
        self._rid_batch: Dict[str, Path] = {}
        if create:
            for d in (self.requests, self.claimed, self.responses):
                d.mkdir(parents=True, exist_ok=True)

    # ---- client side ----

    def submit(
        self,
        *,
        prompt=None,
        prompt_len: Optional[int] = None,
        max_new_tokens: int = 64,
        request_id: Optional[str] = None,
    ) -> str:
        """Drop a request into the spool; returns its id."""
        rec = make_request(
            prompt=prompt,
            prompt_len=prompt_len,
            max_new_tokens=max_new_tokens,
            request_id=request_id,
        )
        return self.enqueue(rec)

    def enqueue(self, rec: dict) -> str:
        """Drop a fully-formed request record into ``requests/`` (the
        single-record primitive: unlike :meth:`submit` it preserves
        the record verbatim — id, prompt, and above all the client's
        original ``submit_time``, which the engine's TTFT accounting is
        measured from)."""
        rid = rec["id"]
        t0 = time.time()
        tmp = self.requests / f".{rid}.tmp"
        tmp.write_text(json.dumps(rec))
        os.rename(tmp, self.requests / f"{rid}.json")
        # Client-enqueue hop span. Dispatch copies the router spills to
        # a REPLICA spool carry "attempts" — those get a dispatch span
        # at the router instead, never a second enqueue.
        if _span_tracer() is not None and "tctx" in rec and "attempts" not in rec:
            serve_span("enqueue", t0, time.time() - t0, rid=rid)
        return rid

    def enqueue_batch(self, recs: List[dict], fsync: bool = True) -> List[str]:
        """Drop MANY request records as ONE spool file: one temp write,
        one (optional) fsync, one rename — the per-request syscall
        count collapses by the batch factor. Returns the rids in frame
        order. An empty batch writes nothing."""
        if not recs:
            return []
        rids = [rec["id"] for rec in recs]
        t0 = time.time()
        bid = uuid.uuid4().hex[:12]
        tmp = self.requests / f".b-{bid}.tmp"
        with open(tmp, "wb") as fh:
            fh.write(encode_frames(recs))
            if fsync:
                fh.flush()
                os.fsync(fh.fileno())
        os.rename(tmp, self.requests / f"b-{bid}{BATCH_SUFFIX}")
        if _span_tracer() is not None:
            dur = time.time() - t0
            for rec in recs:
                if "tctx" in rec and "attempts" not in rec:
                    serve_span("enqueue", t0, dur, rid=rec["id"], batch=len(recs))
        return rids

    def wait_response(self, request_id: str, timeout: float = 60.0) -> dict:
        """Poll for the response record; raises TimeoutError.

        The poll interval follows the shared adaptive backoff schedule
        (2 ms first check, exponential to a 250 ms cap) — an idle
        client waiting out a slow decode costs tens of stat()s, not
        ``timeout / fixed_interval`` of them."""
        path = self.responses / f"{request_id}.json"
        # monotonic: the poll budget is a within-process interval; a
        # clock step must not time out a request that is still cooking.
        deadline = time.monotonic() + timeout
        attempt = 0
        while time.monotonic() < deadline:
            if path.exists():
                return json.loads(path.read_text())
            delay = WAIT_BACKOFF.delay(attempt)
            attempt += 1
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
        raise TimeoutError(f"no response for {request_id} in {timeout}s")

    # ---- engine side ----

    def _claim_batch_file(self, path: Path, out: List[dict]) -> None:
        """Claim one ``.jsonb`` batch: rename whole-file (exactly-once
        vs concurrent claimers), decode every complete frame, register
        the per-record claim bookkeeping. Records of a RECOVERED batch
        that already have a response are dropped (served before the
        previous life crashed)."""
        dst = self.claimed / path.name
        try:
            os.rename(path, dst)
        except FileNotFoundError:
            return  # lost the race with another claimer
        try:
            data = dst.read_bytes()
        except OSError:
            return
        recs, _torn = decode_frames(data)
        recovered = RECOVERED_MARK in path.name
        pending: Set[str] = set()
        for rec in recs:
            rid = rec.get("id")
            if not rid:
                continue
            if recovered and self.has_response(rid):
                continue
            pending.add(rid)
            self._rid_batch[rid] = dst
            out.append(rec)
        if pending:
            self._batch_pending[dst] = pending
        else:
            dst.unlink(missing_ok=True)

    def claim(self, limit: int) -> list[dict]:
        """Claim up to ``limit`` unclaimed requests, oldest first.
        Batch files are claimed whole (one rename); records beyond the
        limit are carried in memory and returned by the next call —
        their durable copy stays in ``claimed/`` until responded."""
        out: list[dict] = []
        limit = max(0, limit)
        while self._carry and len(out) < limit:
            out.append(self._carry.popleft())
        if len(out) >= limit:
            return out

        def mtime(p):
            # A concurrent claimer may rename the file between iterdir
            # and stat; such entries sort last and lose the per-file
            # rename race below instead of aborting the whole batch.
            try:
                return p.stat().st_mtime
            except FileNotFoundError:
                return float("inf")

        try:
            pending = sorted(
                (
                    p
                    for p in self.requests.iterdir()
                    if p.suffix in (".json", BATCH_SUFFIX)
                ),
                key=mtime,
            )
        except FileNotFoundError:
            return out
        for path in pending:
            if len(out) >= limit:
                break
            if path.suffix == BATCH_SUFFIX:
                batch: List[dict] = []
                self._claim_batch_file(path, batch)
                for rec in batch:
                    if len(out) < limit:
                        out.append(rec)
                    else:
                        self._carry.append(rec)
                continue
            dst = self.claimed / path.name
            try:
                os.rename(path, dst)
            except FileNotFoundError:
                continue  # lost a race with another claimer
            try:
                out.append(json.loads(dst.read_text()))
            except (OSError, json.JSONDecodeError):
                # Torn request (a foreign client wrote requests/<id>.json
                # without the tmp+rename discipline and died mid-write).
                # Leaving the claim in place would WEDGE admission: the
                # next recover_claimed() moves it back to requests/,
                # claim() re-claims it, forever. Answer it with an error
                # response instead — the id is the filename — which both
                # unblocks any waiting client and clears the claim.
                self.respond(
                    path.stem, {"id": path.stem, "error": "torn request"}
                )
                continue
        return out

    def recover_claimed(self) -> int:
        """Move claims a dead engine left behind back into ``requests/``
        (skipping single-record claims that already have a response;
        batch files are marked ``.recovered`` so re-claim dedups their
        records the same way). Returns how many records were recovered;
        call once at engine startup."""
        n = 0
        try:
            stuck = list(self.claimed.iterdir())
        except FileNotFoundError:
            return n
        for path in stuck:
            if path.suffix == BATCH_SUFFIX:
                try:
                    recs, _ = decode_frames(path.read_bytes())
                except OSError:
                    recs = []
                stem = path.name[: -len(BATCH_SUFFIX)]
                if not stem.endswith(RECOVERED_MARK):
                    stem += RECOVERED_MARK
                try:
                    os.rename(path, self.requests / (stem + BATCH_SUFFIX))
                    n += len(recs)
                except FileNotFoundError:
                    continue
                continue
            if path.suffix != ".json":
                continue
            if (self.responses / path.name).exists():
                path.unlink(missing_ok=True)
                continue
            try:
                os.rename(path, self.requests / path.name)
                n += 1
            except FileNotFoundError:
                continue
        return n

    def _release_claim(self, request_id: str) -> None:
        """Clear the claimed-side record for a responded request —
        the single ``.json`` claim, or the rid's slot in its batch
        (the batch file is unlinked when its LAST record responds)."""
        batch = self._rid_batch.pop(request_id, None)
        if batch is not None:
            pending = self._batch_pending.get(batch)
            if pending is not None:
                pending.discard(request_id)
                if not pending:
                    del self._batch_pending[batch]
                    batch.unlink(missing_ok=True)
            return
        (self.claimed / f"{request_id}.json").unlink(missing_ok=True)

    def respond(self, request_id: str, record: dict) -> None:
        tmp = self.responses / f".{request_id}.tmp"
        tmp.write_text(json.dumps(record))
        os.rename(tmp, self.responses / f"{request_id}.json")
        self._release_claim(request_id)

    def has_response(self, request_id: str) -> bool:
        return (self.responses / f"{request_id}.json").exists()

    def pending_count(self) -> int:
        """Unclaimed spool files plus carried batch records. A batch
        file counts as ONE regardless of its record count (an exact
        count would cost a read per batch — this is a telemetry gauge,
        not an accounting surface)."""
        try:
            return len(self._carry) + sum(
                1
                for p in self.requests.iterdir()
                if p.suffix in (".json", BATCH_SUFFIX)
            )
        except FileNotFoundError:
            return len(self._carry)
