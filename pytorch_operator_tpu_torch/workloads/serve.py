"""Persistent serving job: spool-fed continuous batching under the
supervisor — the port of ``pytorch_operator_tpu/workloads/serve.py``.

Clients drop requests into a spool directory (``serving/spool.py``), or the
supervisor's router sends them over the shared-memory ring
(``serving/shmring.py``); the engine (``serving/engine.py``) admits them into
cache slots at decode-block boundaries, finished requests free their slot
for the next arrival, and responses carry the per-request latency record
(TTFT, per-token). Metrics, the serve-plane load beat and progress flow
through the status channel the training workloads use, so ``tpujob
describe`` and the router read a port replica like a JAX one.

    python -m pytorch_operator_tpu_torch.workloads.serve --config 0.3b \\
        --spool .tpujob/serve-spool --slots 8 --chunk 128 --block 64 \\
        --max-decode-len 4096 --json

A client: ``Spool(dir).submit(prompt_len=64, max_new_tokens=128)`` then
``Spool(dir).wait_response(rid)``. Weights are random, from ``--seed`` (no
tokenizer here), or a trained run's: ``--restore`` points at a training
job's checkpoint directory and loads the newest step's params alone (the
train -> checkpoint -> serve journey). ``--quantize int8 --kv-quantize int8``
serves the int8 stack of ``examples/serve.yaml`` (int8 weights, int8 KV
cache), on random or restored weights alike. It runs on ``cuda`` unless
``--device cpu`` or ``TPUJOB_PLATFORM=cpu`` asks for the host; with neither
and no GPU it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np

from .. import faults
from ..models import llama as llama_lib
from ..obs.trace import serve_span, tracer as _span_tracer
from ..ops.quantize import state_bytes
from ..runtime import rendezvous
from ..parallel.collectives import world as joined_world
from ..runtime.device import device_name, rank_device, world_device

def run(
    *,
    config: str = "tiny",
    n_layers: int | None = None,
    spool_dir: str,
    slots: int = 8,
    chunk: int = 64,
    block: int = 16,
    max_decode_len: int = 2048,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_token: int | None = None,
    quantize: str | None = None,
    kv_quantize: str | None = None,
    init_host: bool = False,
    restore: str | None = None,
    max_requests: int = 0,
    warmup: int = 0,
    idle_timeout: float = 0.0,
    poll_interval: float = 0.05,
    report_every: float = 5.0,
    transport: str = "spool",
    seed: int = 0,
    device=None,
    log=print,
) -> dict:
    """The serving loop. ``max_requests``/``idle_timeout`` bound the run for
    tests and benches; both 0 means serve forever (the supervisor owns the
    lifecycle). The first ``warmup`` requests served are left out of the
    engine's stats (``reset_stats`` once they are answered), as bench.py's
    engine stream leaves out its warmup pair."""
    from ..serving import Request, ServingEngine
    from ..serving.shmring import EngineTransport
    from .generate import load_params

    dev = world_device(device)
    cfg = getattr(llama_lib, llama_lib.CONFIGS[config])(
        decode=True, max_decode_len=max_decode_len, quantize=quantize, kv_quantize=kv_quantize,
        **({} if n_layers is None else {"n_layers": n_layers}),
    )
    log(
        f"[serve] config={config} layers={cfg.n_layers} slots={slots} chunk={chunk} "
        f"block={block} L={max_decode_len} quantize={quantize} "
        f"kv_quantize={kv_quantize} spool={spool_dir} ({device_name(dev)})"
    )
    model, n_params, *restored = load_params(
        cfg, config=config, device=dev, restore=restore, quantize=quantize,
        init_host=init_host, seed=seed, log=log, tag="serve",
    )
    engine = ServingEngine(
        cfg, model, slots=slots, chunk=chunk, block=block,
        temperature=temperature, top_k=top_k, top_p=top_p,
        eos_token=eos_token, seed=seed,
    )
    # The transport wraps the durable file spool and — when the job's
    # ``spec.serving.transport`` is shmring — attaches the router's
    # shared-memory ring pair once it appears.
    spool = EngineTransport(spool_dir, transport)
    recovered = spool.recover()
    if recovered:
        # A previous life of this job died with claims in flight; they're
        # requests again now.
        log(f"[serve] recovered {recovered} claimed request(s) from a previous life")
    rendezvous.report_first_step(0)

    served = 0
    rejected = 0
    last_activity = time.time()
    last_report = 0.0
    # Engine-claim wall times by rid, for the slot_wait/decode hop spans
    # (populated only while tracing is enabled).
    claims: dict = {}

    def to_request(rec: dict) -> Request:
        if rec.get("prompt") is not None:
            prompt = np.asarray(rec["prompt"], np.int32)
        else:
            # Synthetic prompt of the requested length (no tokenizer here),
            # deterministic per request id ACROSS processes and packages
            # (crc32, not str hash): the JAX serve workload builds the same.
            seed_ = zlib.crc32(rec["id"].encode())
            prompt = np.random.default_rng(seed_).integers(
                0, cfg.vocab_size, (int(rec["prompt_len"]),)
            ).astype(np.int32)
        return Request(
            id=rec["id"],
            prompt=prompt,
            max_new_tokens=int(rec["max_new_tokens"]),
            submit_time=float(rec["submit_time"]),
        )

    def finish(res) -> None:
        nonlocal served, last_activity
        traced = _span_tracer() is not None
        t_resp = time.time() if traced else 0.0
        spool.respond(
            res.id,
            {
                "id": res.id,
                "tokens": res.tokens,
                "prompt_len": res.prompt_len,
                "ttft_ms": round(1000 * res.ttft_s, 3),
                "admit_wait_ms": round(1000 * res.admit_wait_s, 3),
                "tpot_ms": (
                    round(1000 * res.tpot_s, 3) if res.tpot_s is not None else None
                ),
            },
        )
        if traced:
            info = claims.pop(res.id, None)
            if info is not None:
                claim_ts, submit = info
                # The engine's latency record anchors the hops: admit_wait_s
                # is measured from the client's wall-clock submit_time.
                admit_t = submit + res.admit_wait_s
                serve_span("slot_wait", claim_ts, max(0.0, admit_t - claim_ts), rid=res.id)
                serve_span(
                    "decode", admit_t, max(0.0, res.finish_time - admit_t),
                    rid=res.id, tokens=len(res.tokens),
                )
                serve_span("respond", t_resp, time.time() - t_resp, rid=res.id)
        served += 1
        if served == warmup:
            engine.reset_stats()
        last_activity = time.time()

    while True:
        # Admission feed: claim enough to keep the slots fed one iteration
        # ahead (ring tier first, then the file spool).
        polled, _ = spool.poll_requests(2 * slots - engine.queued)
        for rec in polled:
            try:
                req = to_request(rec)
                if _span_tracer() is not None:
                    claims[req.id] = (time.time(), req.submit_time)
                engine.submit(req)
                last_activity = time.time()
            except (ValueError, KeyError, TypeError) as e:
                rejected += 1
                claims.pop(rec.get("id"), None)
                spool.respond(rec.get("id", "unknown"), {"error": str(e)})
        if engine.busy:
            try:
                results = engine.step()
            except faults.InjectedFault as e:
                # A faulted iteration must not strand its in-flight requests:
                # abort the occupied slots and answer each with an error —
                # exactly-once responses, queued requests untouched, the
                # engine keeps serving.
                aborted = engine.abort_in_flight()
                for rid in aborted:
                    claims.pop(rid, None)
                    spool.respond(rid, {"id": rid, "error": f"engine fault: {e}"})
                rejected += len(aborted)
                log(
                    f"[serve] engine step fault ({e}); aborted {len(aborted)} "
                    "in-flight request(s) with error responses"
                )
                results = []
            for res in results:
                finish(res)
        else:
            time.sleep(poll_interval)
        now = time.time()
        if now - last_report > report_every:
            last_report = now
            s = engine.stats()
            rendezvous.report_metrics(
                served,
                serve_requests=served,
                serve_pending=spool.pending_count(),
                serve_decode_tokens_per_sec=s["decode_tokens_per_sec"],
                serve_ttft_ms_p50=s["ttft_ms_p50"],
                serve_tpot_ms_p50=s["tpot_ms_p50"],
            )
            # Serve-plane load beat: the router's least-loaded dispatch and
            # the queue_growth/batch_size_collapse detectors read it.
            rendezvous.report_serve(
                served,
                slots=slots,
                slots_free=engine.slots_free,
                queued=engine.queued,
                pending=spool.pending_count(),
                ttft_ms_p50=s["ttft_ms_p50"],
                ttft_ms_p99=s["ttft_ms_p99"],
                tpot_ms_p50=s["tpot_ms_p50"],
                tpot_ms_p99=s["tpot_ms_p99"],
                # A busy engine frees its next slot one block's worth of
                # per-token time away.
                block_ms=((s["tpot_ms_p50"] or 0.0) * block if engine.busy else 0.0),
            )
            # The live operator surface folds progress records: served
            # requests are the step counter.
            rendezvous.report_progress(
                served, throughput=s["decode_tokens_per_sec"] or 0.0, unit="tok/s"
            )
        if max_requests and served >= max_requests and not engine.busy:
            break
        if idle_timeout and not engine.busy and now - last_activity > idle_timeout:
            log(f"[serve] idle for {idle_timeout}s, exiting")
            break

    stats = engine.stats()
    stats.update(
        served=served,
        rejected=rejected,
        params_m=round(n_params / 1e6, 1),
        config=config,
        transport=transport,
        ring_recvs=spool.ring_recvs,
        ring_sends=spool.ring_sends,
        device=device_name(dev),
    )
    if quantize:
        stats["weight_mb"] = round(state_bytes(model.state_dict()) / 1e6, 2)
    if restored:
        stats["restored_step"] = restored[0]
    spool.close()
    if stats["decode_tokens_per_sec"]:
        stats["decode_tokens_per_sec_per_chip"] = round(
            stats["decode_tokens_per_sec"] / joined_world()[1], 1
        )
    rendezvous.report_metrics(served, **{
        k: v for k, v in stats.items()
        if isinstance(v, (int, float)) and v is not None
    })
    log(f"[serve] done: {json.dumps(stats)}")
    return stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", choices=sorted(llama_lib.CONFIGS), default="tiny")
    p.add_argument(
        "--layers", type=int, default=None, dest="n_layers",
        help="the preset's depth cut to this many layers (as llama_train --layers; "
        "a checkpoint must have been trained at the same depth)",
    )
    p.add_argument(
        "--spool",
        default=os.environ.get("TPUJOB_SPOOL_DIR") or None,
        help="spool directory (requests/ claimed/ responses/); defaults to "
        "the supervisor-injected TPUJOB_SPOOL_DIR",
    )
    p.add_argument("--slots", type=int, default=8, help="concurrent cache slots (the serving batch)")
    p.add_argument("--chunk", type=int, default=64, help="prefill chunk length (bounds prefill memory)")
    p.add_argument(
        "--block", type=int, default=16,
        help="decode steps per block; admission happens at block boundaries",
    )
    p.add_argument("--max-decode-len", type=int, default=2048)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--eos-token", type=int, default=None)
    p.add_argument("--quantize", choices=["int8"], default=None)
    p.add_argument("--kv-quantize", choices=["int8"], default=None)
    p.add_argument("--init-host", action="store_true")
    p.add_argument(
        "--restore", default=None, metavar="CKPT_DIR",
        help="serve a trained checkpoint: params of the newest step under this "
        "directory (a llama_train job's TPUJOB_CHECKPOINT_DIR)",
    )
    p.add_argument(
        "--max-requests", type=int, default=0,
        help="exit after serving N requests (0 = serve forever)",
    )
    p.add_argument(
        "--idle-timeout", type=float, default=0.0,
        help="exit after this many idle seconds (0 = serve forever)",
    )
    p.add_argument(
        "--report-every", type=float, default=5.0,
        help="seconds between progress/metrics reports to the supervisor surface",
    )
    p.add_argument(
        "--transport",
        choices=("spool", "shmring"),
        default=os.environ.get("TPUJOB_SERVE_TRANSPORT") or "spool",
        help="router transport tier; defaults to the supervisor-injected "
        "TPUJOB_SERVE_TRANSPORT (spec.serving.transport)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--device", default=None,
        help="cuda (default) or cpu; TPUJOB_PLATFORM=cpu also selects the CPU",
    )
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    if not args.spool:
        p.error("--spool is required (no TPUJOB_SPOOL_DIR in the environment)")

    # Every serve process is an engine of its own: it joins no process group
    # (serving issues no collective), so a replica of a serving fleet that
    # is restarted alone serves again at once. In a world of several it
    # takes its rank's card.
    world = rendezvous.fenced_world_from_env()
    device = args.device
    if world.num_processes > 1:
        device = rank_device(world.process_id, device)
    stats = run(
        config=args.config,
        n_layers=args.n_layers,
        spool_dir=args.spool,
        slots=args.slots,
        chunk=args.chunk,
        block=args.block,
        max_decode_len=args.max_decode_len,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        eos_token=args.eos_token,
        quantize=args.quantize,
        kv_quantize=args.kv_quantize,
        init_host=args.init_host,
        restore=args.restore,
        max_requests=args.max_requests,
        idle_timeout=args.idle_timeout,
        report_every=args.report_every,
        transport=args.transport,
        seed=args.seed,
        device=device,
        log=lambda msg: print(msg, flush=True),
    )
    if args.json and world.process_id == 0:
        print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
