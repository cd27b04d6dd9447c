"""Continuous-batching decode engine — the port of
``pytorch_operator_tpu/serving/engine.py``.

A fixed set of cache slots, each independently holding a request at its own
depth, refilled the moment its occupant finishes. Same knobs, validation,
error messages, admission rule, latency accounting and ``stats()`` record as
the JAX engine; the tests hold its greedy tokens to the JAX engine's token
for token.

- Decode: ``step()`` runs ``block`` single-token steps over the full
  ``[slots]`` batch through a ``decode_per_row=True`` model, every row at
  its own position; finished and empty rows are parked (they re-write their
  own slot, masked from every live stream by the col <= row mask). The
  row tokens, positions, the active mask and the sampled tokens stay on the
  device through the block; the host reads them once, with one copy of the
  ``[slots, block]`` tokens at its end. Admission happens at block
  boundaries.
- Prefill: fixed-size chunks through a ``prefill_mode="cache"`` model,
  batch-uniform, into per-layer views ``slab[slot:slot+1]`` of the batch
  cache: the model's in-place cache writes land in the batch cache without
  a copy of the slabs. The last chunk is padded; the pad tokens write cache
  slots past the prompt that every later read either masks (col <= row) or
  overwrites (the next decode token lands exactly on the first padded slot
  before anything attends it), so no zeroing pass is needed.
- Slot L-1 of every row is a parking slot: rows that exhaust their budget
  clamp there, so admission requires prompt + new <= L-1.

Both model variants are built on the ``meta`` device and take the loaded
model's tensors with ``load_state_dict(..., assign=True)``: they share its
weight storage, and nothing is copied.

Latency accounting: TTFT per request (submit -> first sampled token, host
clock around the real work); per-token latency samples at block granularity
(block wall / tokens accepted in the block), the source of the p50/p99.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import faults
from ..models import llama as llama_lib
from ..ops.sampling import make_sampler, validate_sampling


@dataclasses.dataclass
class Request:
    id: str
    prompt: np.ndarray  # [p] int32 token ids
    max_new_tokens: int
    submit_time: float  # client wall clock (time.time())


@dataclasses.dataclass
class RequestResult:
    id: str
    prompt_len: int
    tokens: list[int]  # generated tokens (EOS kept if hit)
    ttft_s: float  # submit -> first token out of prefill
    admit_wait_s: float  # submit -> admission (queueing component)
    tpot_s: Optional[float]  # (finish - first token) / (n - 1)
    finish_time: float


@dataclasses.dataclass
class _Slot:
    request: Request
    admit_time: float
    first_token_time: float
    pos: int  # position of the last accepted token
    remaining: int
    tokens: list[int]
    done: bool = False


def _variant(model: llama_lib.Llama, cfg: llama_lib.LlamaConfig) -> llama_lib.Llama:
    """``cfg``'s model over ``model``'s tensors (shared storage, no copy)."""
    m = llama_lib.Llama(cfg, device="meta")
    m.load_state_dict(model.state_dict(), assign=True)
    return m.requires_grad_(False).eval()


class ServingEngine:
    """Slot-based continuous batching over the llama decode stack.

    ``cfg`` must be a decode config (``decode=True``); ``model`` is the
    loaded port ``Llama`` holding the weights (``generate.load_params``).
    The engine builds its own per-row decode and chunked-prefill variants
    of it and runs on the model's device.
    """

    def __init__(
        self,
        cfg,
        model,
        *,
        slots: int = 8,
        chunk: int = 64,
        block: int = 16,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_token: Optional[int] = None,
        seed: int = 0,
    ):
        if not cfg.decode:
            raise ValueError("ServingEngine needs a decode=True config")
        if getattr(model, "tp", None) is not None:
            raise NotImplementedError(
                "serving a tensor-parallel Llama: the engine runs one process's whole model "
                "(JAX's serve takes no mesh)"
            )
        if chunk < 1 or block < 1 or slots < 1:
            raise ValueError("slots, chunk and block must be >= 1")
        if cfg.max_decode_len < chunk + 1:
            raise ValueError(
                f"max_decode_len {cfg.max_decode_len} too small for "
                f"chunk {chunk} (+1 parking slot)"
            )
        validate_sampling(temperature, top_k, top_p)
        self.cfg = dataclasses.replace(cfg, decode_per_row=False, prefill_mode="self")
        self.slots = slots
        self.chunk = chunk
        self.block = block
        self.eos_token = eos_token
        self._temperature = temperature
        dev = model.lm_head.weight.device
        self.device = dev
        self._decode_model = _variant(
            model, dataclasses.replace(self.cfg, decode_per_row=True)
        )
        self._prefill_model = _variant(
            model, dataclasses.replace(self.cfg, prefill_mode="cache")
        )
        self._sample = make_sampler(temperature, top_k, top_p)
        # Decode blocks draw from ``seed``, first tokens from ``seed + 1``
        # (the JAX engine's two keys).
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self._first_gen = torch.Generator(device=dev).manual_seed(seed + 1)
        self._cache = llama_lib.init_decode_cache(self.cfg, slots, device=dev)
        self._tok = torch.zeros((slots,), dtype=torch.long, device=dev)
        self._pos = torch.zeros((slots,), dtype=torch.long, device=dev)
        self._slots: list[Optional[_Slot]] = [None] * slots
        self._queue: deque[Request] = deque()
        # Latency/throughput accounting.
        self.completed: list[RequestResult] = []
        self._tpot_samples: list[float] = []
        self._decode_tokens = 0
        self._decode_wall = 0.0

    # ---- admission ----

    def submit(self, request: Request) -> None:
        p = int(np.asarray(request.prompt).shape[0])
        L = self.cfg.max_decode_len
        if p < 1:
            raise ValueError(f"{request.id}: empty prompt")
        if request.max_new_tokens < 1:
            # Admission would still emit the prefill's first token, and a
            # negative budget weakens the cache-budget inequality.
            raise ValueError(
                f"{request.id}: max_new_tokens "
                f"{request.max_new_tokens} must be >= 1"
            )
        # Valid stream cap (L-1 reserves the parking slot) AND the padded
        # prefill tail must stay inside the cache.
        padded = -(-p // self.chunk) * self.chunk
        if p + request.max_new_tokens > L - 1 or padded > L:
            raise ValueError(
                f"{request.id}: prompt {p} + max_new "
                f"{request.max_new_tokens} exceeds the cache budget "
                f"(max_decode_len {L}, 1 slot reserved)"
            )
        self._queue.append(request)

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    @torch.no_grad()
    def _prefill_chunk(self, slot: int, chunk_toks, start: int, last_idx: Optional[int]):
        """One ``[1, chunk]`` chunk at positions ``[start, start + chunk)``
        into row ``slot`` of the batch cache. Returns the f32 head logits
        ``[V]`` of position ``last_idx`` of the chunk, or None when
        ``last_idx`` is None (intermediate chunks: the head matmul costs as
        much as several layers and its result would be discarded)."""
        row = {
            name: {"attn": {k: s[slot : slot + 1] for k, s in layer["attn"].items()}}
            for name, layer in self._cache.items()
        }
        pos = torch.arange(start, start + self.chunk, device=self.device)[None, :]
        hidden, _ = llama_lib.decode_forward(
            self._prefill_model, row, chunk_toks, pos, return_hidden=True
        )
        if last_idx is None:
            return None
        h = hidden[:, last_idx]  # [1, D]
        return (h.float() @ self._prefill_model.head_kernel().float())[0]

    @torch.no_grad()
    def _decode_block(self, active):
        """``block`` decode steps over all slots. ``self._tok``/``_pos``
        [slots] are each row's last accepted token and its position; parked
        rows (``active`` False) hold position and re-write their own slot.
        Everything stays on the device; returns the sampled tokens
        ``[slots, block]`` on the device."""
        L = self.cfg.max_decode_len
        tok, pos = self._tok, self._pos
        out = []
        for _ in range(self.block):
            logits, _ = llama_lib.decode_forward(
                self._decode_model, self._cache, tok[:, None], pos[:, None],
                return_hidden=False,
            )
            nxt = torch.where(active, self._sample(logits[:, -1], self._gen), tok)
            pos = torch.where(active, torch.clamp(pos + 1, max=L - 1), pos)
            tok = nxt
            out.append(nxt)
        self._tok, self._pos = tok, pos
        return torch.stack(out, dim=1)

    def _sample_first(self, logits) -> int:
        """Sample the request's first token from the prefill's [V] logits:
        greedy on the host (numpy's first-maximum rule, as the JAX engine),
        else the decode blocks' sampler on the first-token generator."""
        if self._temperature == 0.0:
            return int(np.argmax(logits.cpu().numpy()))
        return int(self._sample(logits[None, :], self._first_gen)[0])

    def _admit(self, request: Request, slot: int) -> None:
        admit_time = time.time()
        prompt = np.asarray(request.prompt, np.int32)
        p = prompt.shape[0]
        padded = -(-p // self.chunk) * self.chunk
        buf = np.zeros((padded,), np.int64)
        buf[:p] = prompt
        toks = torch.from_numpy(buf).to(self.device)
        last_valid = (p - 1) % self.chunk  # index within the FINAL chunk
        logits = None
        for start in range(0, padded, self.chunk):
            final = start + self.chunk >= padded
            # Only the final chunk's last VALID position (not the padded
            # tail) feeds the first token.
            logits = self._prefill_chunk(
                slot, toks[None, start : start + self.chunk], start,
                last_valid if final else None,
            )
        first = self._sample_first(logits)
        first_time = time.time()
        st = _Slot(
            request=request,
            admit_time=admit_time,
            first_token_time=first_time,
            pos=p - 1,
            remaining=request.max_new_tokens,
            tokens=[],
        )
        self._accept_token(st, slot, first)
        self._slots[slot] = st
        # Row state: the first sampled token has NOT been written to the
        # cache yet — the decode block writes its k/v at position p
        # (st.pos after the accept) before attending, exactly as
        # make_generate's first decode step does.
        self._tok[slot] = first
        self._pos[slot] = st.pos

    def _accept_token(self, st: _Slot, slot: int, token: int) -> None:
        st.tokens.append(int(token))
        st.pos += 1
        st.remaining -= 1
        if st.remaining <= 0 or (self.eos_token is not None and token == self.eos_token):
            st.done = True

    # ---- the engine iteration ----

    def step(self) -> list[RequestResult]:
        """One engine iteration: admit into free slots at this block
        boundary, run one decode block, harvest finished requests. Returns
        the requests completed this iteration."""
        # Fault-injection site: a ``fail_engine_step`` plan entry makes this
        # iteration raise InjectedFault — the serve loop's recovery
        # (abort_in_flight + error responses) is what chaos tests pin.
        faults.engine_step_check()
        # 1. Admission.
        for slot in self._free_slots():
            if not self._queue:
                break
            self._admit(self._queue.popleft(), slot)
        # Harvest single-token requests that finished inside prefill.
        finished = self._harvest()
        active_rows = [i for i, s in enumerate(self._slots) if s is not None]
        if not active_rows:
            return finished
        # 2. One decode block over the full slot batch.
        active = torch.zeros((self.slots,), dtype=torch.bool)
        active[active_rows] = True
        t0 = time.time()
        toks = self._decode_block(active.to(self.device)).cpu().numpy()  # the one fence
        wall = time.time() - t0
        live = 0
        for i in active_rows:
            st = self._slots[i]
            accepted = 0
            for t in toks[i]:
                if st.done:
                    break
                self._accept_token(st, i, int(t))
                accepted += 1
            if accepted:
                # Per-REQUEST experienced latency: every occupied slot
                # waited the whole block wall for its `accepted` tokens.
                self._tpot_samples.append(wall / accepted)
            live += accepted
        if live:
            self._decode_tokens += live
            self._decode_wall += wall
        return finished + self._harvest()

    def _harvest(self) -> list[RequestResult]:
        out = []
        for i, st in enumerate(self._slots):
            if st is None or not st.done:
                continue
            now = time.time()
            n = len(st.tokens)
            out.append(
                RequestResult(
                    id=st.request.id,
                    prompt_len=int(np.asarray(st.request.prompt).shape[0]),
                    tokens=st.tokens,
                    ttft_s=st.first_token_time - st.request.submit_time,
                    admit_wait_s=st.admit_time - st.request.submit_time,
                    tpot_s=((now - st.first_token_time) / (n - 1) if n > 1 else None),
                    finish_time=now,
                )
            )
            self._slots[i] = None  # the slot is free for the next admit
        self.completed.extend(out)
        return out

    def abort_in_flight(self) -> list[str]:
        """Evict every occupied slot and return the aborted request ids
        (the serve loop answers each with an error response). Queued
        requests stay queued. No cache surgery: admission prefills a row in
        full before any decode reads it, so a freed slot's stale k/v never
        leaks into a later request."""
        aborted = []
        for i, st in enumerate(self._slots):
            if st is not None:
                aborted.append(st.request.id)
                self._slots[i] = None
        return aborted

    @property
    def queued(self) -> int:
        """Requests admitted to the engine but not yet in a slot."""
        return len(self._queue)

    @property
    def slots_free(self) -> int:
        """Unoccupied cache slots (the serve-plane load beat's headroom)."""
        return sum(1 for s in self._slots if s is None)

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def run_until_drained(self, max_iters: int = 10_000):
        """Drive step() until queue and slots are empty (test/bench helper;
        the serve workload loops step() itself to interleave polling)."""
        out = []
        for _ in range(max_iters):
            if not self.busy:
                return out
            out.extend(self.step())
        raise RuntimeError("engine did not drain")

    def reset_stats(self) -> None:
        """Clear the latency/throughput accumulators (benches call this
        after warmup requests so percentiles reflect steady state)."""
        self.completed.clear()
        self._tpot_samples.clear()
        self._decode_tokens = 0
        self._decode_wall = 0.0

    def stats(self) -> dict:
        """Aggregate latency/throughput record (the JAX engine's keys)."""
        done = self.completed
        ttft = sorted(r.ttft_s for r in done)
        tpot = sorted(self._tpot_samples)

        def pct(xs, q):
            if not xs:
                return None
            i = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
            return round(1000 * xs[i], 3)

        return {
            "requests": len(done),
            "generated_tokens": sum(len(r.tokens) for r in done),
            "decode_tokens_per_sec": round(self._decode_tokens / self._decode_wall, 1)
            if self._decode_wall
            else None,
            "ttft_ms_p50": pct(ttft, 0.50),
            "ttft_ms_p99": pct(ttft, 0.99),
            "tpot_ms_p50": pct(tpot, 0.50),
            "tpot_ms_p99": pct(tpot, 0.99),
            "slots": self.slots,
            "block": self.block,
            "chunk": self.chunk,
        }
