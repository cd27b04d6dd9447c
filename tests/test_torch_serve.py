"""The port's serve workload and its transport
(pytorch_operator_tpu_torch/workloads/serve.py, serving/{spool,shmring}.py,
obs/trace.py, runtime/rendezvous.report_serve) against the JAX package's
router side and supervisor, on the CPU.

- Byte compatibility both ways: the port's batch framing is the JAX
  framing; a JAX ``Spool`` client and a JAX ``RouterRingPort`` talk to a
  port ``EngineTransport``, and read its answers.
- ``serve.run`` with a client thread: responses, the status records the
  supervisor folds (``metrics`` and ``serve``, with the JAX field names).
- A port serve job runs to success under the unchanged supervisor.
- The int8 stack (``--quantize int8 --kv-quantize int8 --init-host``)
  answers over the spool with the single-stream rollout's tokens.
- ``--restore`` serves the params of a checkpoint that the port's
  llama_train wrote, with the single-stream rollout's tokens.
- An injected engine fault answers each in-flight request exactly once with
  an error; without a CPU request the entry point needs a GPU; the port's
  spans load through the JAX loader.
"""

import collections
import json
import threading
import time

import numpy as np
import pytest

from pytorch_operator_tpu.obs import trace as jax_trace
from pytorch_operator_tpu.runtime import rendezvous as jax_rendezvous
from pytorch_operator_tpu.serving import Spool as JaxSpool
from pytorch_operator_tpu.serving import spool as jax_spool
from pytorch_operator_tpu.serving.shmring import RouterRingPort
from pytorch_operator_tpu_torch import faults as port_faults
from pytorch_operator_tpu_torch.obs import trace as port_trace
from pytorch_operator_tpu_torch.serving import EngineTransport, Spool
from pytorch_operator_tpu_torch.serving import spool as port_spool
from pytorch_operator_tpu_torch.workloads import serve

TINY = dict(config="tiny", slots=2, chunk=8, block=4, max_decode_len=48, device="cpu")


def _recs(n, tag):
    return [
        jax_spool.make_request(
            prompt=[1, 2, 3 + i] if i % 2 else None,
            prompt_len=None if i % 2 else 5 + i,
            max_new_tokens=4 + i,
            request_id=f"{tag}{i:04d}",
        )
        for i in range(n)
    ]


def test_batch_framing_is_byte_compatible():
    recs = _recs(5, "f") + [{"id": "ü", "x": 1.5, "nested": {"a": [1, None, True]}}]
    data = jax_spool.encode_frames(recs)
    assert port_spool.encode_frames(recs) == data
    assert port_spool.decode_frames(data) == jax_spool.decode_frames(data) == (recs, 0)
    torn = data[:-7] + b"\n" + data[:30]
    assert port_spool.decode_frames(torn) == jax_spool.decode_frames(torn)
    assert port_spool.make_request(prompt_len=3, request_id="x")["tctx"]["p"] == (
        jax_spool.make_request(prompt_len=3, request_id="x")["tctx"]["p"]
    )


@pytest.mark.parametrize(
    "kw",
    [{}, dict(base_s=0.002, cap_s=0.25, factor=1.5, seed=7), dict(base_s=0.005, jitter=0.0)],
    ids=["default", "spool_wait", "no_jitter"],
)
def test_backoff_schedule_equals_jax(kw):
    """Both packages poll on the identical schedule, past the cap crossover
    and at attempt counts an idle loop reaches after hours."""
    from pytorch_operator_tpu.backoff import Backoff as JaxBackoff
    from pytorch_operator_tpu_torch.backoff import Backoff

    attempts = [*range(64), 1023, 1024, 10**6]
    assert [Backoff(**kw).delay(a) for a in attempts] == [JaxBackoff(**kw).delay(a) for a in attempts]


def test_jax_spool_client_port_engine_transport(tmp_path):
    """A JAX client submits (one file each, and one batch file); the port
    transport claims every record and responds; the JAX client reads each
    answer, and no claim is left behind."""
    client = JaxSpool(tmp_path / "sp")
    single = [client.submit(prompt_len=4, max_new_tokens=2) for _ in range(2)]
    batch = client.enqueue_batch(_recs(3, "b"))
    et = EngineTransport(tmp_path / "sp", "spool")
    assert et.pending_count() == 3
    polled, from_ring = et.poll_requests(16)
    assert from_ring == 0
    assert sorted(r["id"] for r in polled) == sorted(single + batch)
    for rec in polled:
        et.respond(rec["id"], {"id": rec["id"], "tokens": [7, rec["max_new_tokens"]]})
    for rec in polled:
        assert client.wait_response(rec["id"], timeout=5)["tokens"] == [7, rec["max_new_tokens"]]
    assert list(client.claimed.iterdir()) == []
    et.close()


def test_jax_router_ring_port_engine_transport(tmp_path):
    """The JAX router's ring pair and the port engine share one layout: the
    router's requests arrive over the ring, the engine's responses go back
    over it, and a ring record the port pushes is what the router decodes."""
    root = tmp_path / "sp"
    router = RouterRingPort(root, capacity=8192)
    et = EngineTransport(root, "shmring")
    sent = _recs(4, "r")
    assert all(router.send(r) for r in sent)
    polled, from_ring = et.poll_requests(8)
    assert et.ring_attached and from_ring == 4 and polled == sent
    for rec in polled:
        et.respond(rec["id"], {"id": rec["id"], "tokens": [1, 2]})
    assert et.ring_sends == 4
    assert router.recv() == [{"id": r["id"], "tokens": [1, 2]} for r in sent]
    # Ring full: the response spills to the spool file.
    big = {"id": "big", "tokens": list(range(3000))}
    et.respond("big", big)
    assert et.ring_send_spills == 1
    assert JaxSpool(root).read_response("big") == big
    et.close()
    router.close()


def _client(spool, plan, got, delay=0.0):
    def run():
        time.sleep(delay)
        ids = [spool.submit(**kw) for kw in plan]
        for rid in ids:
            got[rid] = spool.wait_response(rid, timeout=120)

    t = threading.Thread(target=run)
    t.start()
    return t


def test_serve_run_with_concurrent_client(tmp_path, monkeypatch):
    status = tmp_path / "status"
    status.mkdir()
    monkeypatch.setenv("TPUJOB_STATUS_DIR", str(status))
    monkeypatch.setenv("TPUJOB_REPLICA_TYPE", "Master")
    monkeypatch.setenv("TPUJOB_REPLICA_INDEX", "0")
    sp = Spool(tmp_path / "spool")
    got = {}
    t = _client(sp, [
        dict(prompt_len=5, max_new_tokens=6),
        dict(prompt=[1, 2, 3, 4], max_new_tokens=4),
        dict(prompt_len=30, max_new_tokens=40),  # over budget at L=48 -> rejected
    ], got, delay=0.5)
    stats = serve.run(
        spool_dir=str(sp.root), max_requests=2, idle_timeout=60, report_every=0.0,
        log=lambda *_: None, **TINY,
    )
    t.join(timeout=120)
    assert not t.is_alive()
    assert stats["served"] == 2 and stats["rejected"] == 1
    assert stats["device"] == "cpu" and stats["decode_tokens_per_sec_per_chip"] > 0
    ok = sorted((r for r in got.values() if "tokens" in r), key=lambda r: len(r["tokens"]))
    bad = [r for r in got.values() if "error" in r]
    assert [len(r["tokens"]) for r in ok] == [4, 6] and len(bad) == 1
    assert "budget" in bad[0]["error"]
    for r in ok:
        assert r["ttft_ms"] > 0 and r["prompt_len"] in (4, 5)
        assert all(0 <= x < 256 for x in r["tokens"])
    recs = [json.loads(line) for line in (status / "master-0.jsonl").read_text().splitlines()]
    metrics = [r for r in recs if r["event"] == "metrics" and "ttft_ms_p50" in r]
    assert metrics and metrics[-1]["requests"] == 2 and metrics[-1]["served"] == 2
    beats = [r for r in recs if r["event"] == "serve"]
    assert beats
    # The serve beat carries the JAX package's field names.
    monkeypatch.setenv("TPUJOB_STATUS_DIR", str(tmp_path))
    jax_rendezvous.report_serve(
        2, slots=2, slots_free=2, ttft_ms_p50=1.0, ttft_ms_p99=1.0,
        tpot_ms_p50=1.0, tpot_ms_p99=1.0, block_ms=0.0,
    )
    (ref,) = [json.loads(x) for x in (tmp_path / "master-0.jsonl").read_text().splitlines()]
    assert set(beats[-1]) == set(ref)


def test_serve_run_leaves_warmup_out_of_stats(tmp_path):
    """``warmup=1``: the first request is answered, then the engine's stats
    count only the requests served after it."""
    sp = Spool(tmp_path / "spool")
    got = {}

    def client():
        first = sp.submit(prompt_len=5, max_new_tokens=3)
        got[first] = sp.wait_response(first, timeout=120)
        ids = [sp.submit(prompt_len=6, max_new_tokens=n) for n in (4, 5)]
        for rid in ids:
            got[rid] = sp.wait_response(rid, timeout=120)

    t = threading.Thread(target=client)
    t.start()
    stats = serve.run(
        spool_dir=str(sp.root), max_requests=3, warmup=1, idle_timeout=60,
        log=lambda *_: None, **TINY,
    )
    t.join(timeout=120)
    assert not t.is_alive()
    assert stats["served"] == 3 and len(got) == 3
    assert stats["requests"] == 2 and stats["generated_tokens"] == 9


def test_port_serve_job_under_supervisor(tmp_path):
    """A port serve replica under the unchanged supervisor, fed through the
    spool by a client thread, exits cleanly after its request budget."""
    from pytorch_operator_tpu.api import ProcessTemplate, ReplicaType, Resources
    from pytorch_operator_tpu.controller import Supervisor
    from pytorch_operator_tpu.controller.progress import job_status_dir
    from pytorch_operator_tpu.controller.store import job_key
    from tests.testutil import new_job

    spool_dir = tmp_path / "spool"
    sp = JaxSpool(spool_dir)
    got = {}
    t = _client(sp, [
        dict(prompt_len=5, max_new_tokens=6),
        dict(prompt=[3, 1, 4, 1, 5], max_new_tokens=4),
    ], got)
    sup = Supervisor(state_dir=tmp_path / "state", poll_interval=0.1)
    job = new_job(name="serve-torch", workers=0)
    job.spec.port = None
    job.spec.replica_specs[ReplicaType.MASTER].template = ProcessTemplate(
        module="pytorch_operator_tpu_torch.workloads.serve",
        args=[
            "--config", "tiny", "--spool", str(spool_dir),
            "--slots", "2", "--chunk", "8", "--block", "4",
            "--max-decode-len", "48", "--max-requests", "2",
            "--idle-timeout", "120", "--json",
        ],
        resources=Resources(cpu_devices=1),
    )
    try:
        done = sup.run(job, timeout=240)
        t.join(timeout=60)
        log = (tmp_path / "state" / "logs" / "default_serve-torch-master-0.log").read_text()
        assert done.is_succeeded(), f"log:\n{log[-3000:]}"
        assert "(cpu)" in log
    finally:
        sup.shutdown()
    assert not t.is_alive() and len(got) == 2
    assert sorted(len(r["tokens"]) for r in got.values()) == [4, 6]
    status = (
        job_status_dir(tmp_path / "state" / "status", job_key(done)) / "master-0.jsonl"
    ).read_text()
    metrics = [
        r for r in map(json.loads, status.splitlines())
        if r.get("event") == "metrics" and "ttft_ms_p50" in r
    ]
    assert metrics and metrics[-1]["requests"] == 2, status[-1500:]


def test_injected_engine_fault_answers_in_flight_once(tmp_path, monkeypatch):
    """fail_engine_step on the second iteration: the two requests then in
    the slots get one error response each, the queued two are served."""
    monkeypatch.setenv(
        "TPUJOB_FAULT_PLAN", json.dumps({"faults": [{"kind": "fail_engine_step", "nth": 2}]})
    )
    port_faults.reset()
    counts = collections.Counter()
    real = Spool.respond

    def counting(self, rid, record):
        counts[rid] += 1
        return real(self, rid, record)

    monkeypatch.setattr(Spool, "respond", counting)
    sp = Spool(tmp_path / "spool")
    ids = [sp.submit(prompt_len=5, max_new_tokens=6) for _ in range(4)]
    try:
        stats = serve.run(
            spool_dir=str(sp.root), max_requests=2, idle_timeout=30,
            log=lambda *_: None, **TINY,
        )
    finally:
        port_faults.reset()
    assert stats["served"] == 2 and stats["rejected"] == 2
    assert sorted(counts) == sorted(ids) and set(counts.values()) == {1}
    out = [sp.wait_response(rid, timeout=5) for rid in ids]
    errors = [r for r in out if "error" in r]
    assert len(errors) == 2
    assert all("engine fault" in r["error"] and "fail_engine_step" in r["error"] for r in errors)
    assert sorted(len(r.get("tokens", [])) for r in out) == [0, 0, 6, 6]
    assert sp.pending_count() == 0 and list(sp.claimed.iterdir()) == []


def test_main_serves_restored_weights_over_the_spool(tmp_path, capsys, monkeypatch):
    """``--restore``: a tiny run trained by the port's llama_train with
    ``--checkpoint-every`` is served over the spool; every answer equals
    the single-stream rollout on the checkpoint's params, the stats name the
    step, and the served weights are the checkpoint's (not the seed's)."""
    import torch

    from pytorch_operator_tpu_torch.checkpoint import CheckpointManager
    from pytorch_operator_tpu_torch.models import llama as port_llama
    from pytorch_operator_tpu_torch.workloads import generate, llama_train

    ck = tmp_path / "ck"
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", str(ck))
    trained = llama_train.run(
        config="tiny", batch_size=4, seq_len=16, steps=3, warmup=1, lr=1e-2,
        checkpoint_every=2, device="cpu", log=lambda m: None,
    )
    monkeypatch.delenv("TPUJOB_CHECKPOINT_DIR")
    assert CheckpointManager(ck, create=False).all_steps() == [2, 4]
    sp = Spool(tmp_path / "spool")
    got = {}
    plan = [dict(prompt=[5, 9, 2, 7, 1], max_new_tokens=6), dict(prompt=list(range(11)), max_new_tokens=9)]
    t = _client(sp, plan, got)
    assert serve.main([
        "--config", "tiny", "--spool", str(sp.root), "--device", "cpu", "--slots", "2",
        "--chunk", "8", "--block", "4", "--max-decode-len", "48", "--max-requests", "2",
        "--idle-timeout", "60", "--restore", str(ck), "--json",
    ]) == 0
    t.join(timeout=120)
    assert not t.is_alive() and len(got) == 2
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["served"] == 2 and stats["rejected"] == 0
    assert stats["restored_step"] == trained["end_step"] == 4
    cfg = port_llama.llama_tiny(decode=True, max_decode_len=48)
    model, _, step = generate.load_params(
        cfg, config="tiny", device="cpu", restore=str(ck), log=lambda m: None
    )
    _, params = CheckpointManager(ck, create=False).restore_subtree("params")
    assert step == 4 and all(torch.equal(model.state_dict()[k], v) for k, v in params.items())
    fresh, _ = generate.load_params(cfg, config="tiny", device="cpu", log=lambda m: None)
    assert not torch.equal(fresh.embed.weight, model.embed.weight)
    want = {}
    for kw in plan:
        gen = generate.make_generate(model, max_new_tokens=kw["max_new_tokens"])
        toks, _ = gen(generate.init_cache(model, 1), torch.tensor([kw["prompt"]]), torch.Generator())
        want[len(kw["prompt"])] = toks[0].tolist()
    assert {r["prompt_len"]: r["tokens"] for r in got.values()} == want


def test_main_serves_the_int8_stack_over_the_spool(tmp_path, capsys):
    """``--quantize int8 --kv-quantize int8 --init-host`` (examples/serve.yaml's
    int8 stack): every request answered over the spool, each one's tokens
    those of the single-stream rollout on the same int8 weights and int8
    cache, and ``weight_mb`` in the stats."""
    import torch

    from pytorch_operator_tpu_torch.models import llama as port_llama
    from pytorch_operator_tpu_torch.workloads import generate

    sp = Spool(tmp_path / "spool")
    got = {}
    plan = [dict(prompt=[5, 9, 2, 7, 1], max_new_tokens=6), dict(prompt=list(range(11)), max_new_tokens=9)]
    t = _client(sp, plan, got)
    assert serve.main([
        "--config", "tiny", "--spool", str(sp.root), "--device", "cpu", "--slots", "2",
        "--chunk", "8", "--block", "4", "--max-decode-len", "48", "--max-requests", "2",
        "--idle-timeout", "60", "--quantize", "int8", "--kv-quantize", "int8", "--init-host",
        "--json",
    ]) == 0
    t.join(timeout=120)
    assert not t.is_alive() and len(got) == 2
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["served"] == 2 and stats["rejected"] == 0 and stats["weight_mb"] > 0
    cfg = port_llama.llama_tiny(decode=True, max_decode_len=48, quantize="int8", kv_quantize="int8")
    model, _ = generate.load_params(
        cfg, config="tiny", device="cpu", quantize="int8", init_host=True, log=lambda m: None
    )
    want = {}
    for kw in plan:
        gen = generate.make_generate(model, max_new_tokens=kw["max_new_tokens"])
        toks, _ = gen(generate.init_cache(model, 1), torch.tensor([kw["prompt"]]), torch.Generator())
        want[len(kw["prompt"])] = toks[0].tolist()
    assert {r["prompt_len"]: r["tokens"] for r in got.values()} == want


def test_main_without_cpu_request_needs_a_gpu(tmp_path, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the no-fallback path is not reachable")
    monkeypatch.delenv("TPUJOB_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--spool", str(tmp_path), "--max-requests", "1"])
    monkeypatch.setenv("TPUJOB_SPOOL_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--device", "cuda"])


def test_trace_spans_load_through_jax_loader(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUJOB_TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("TPUJOB_REPLICA_TYPE", "Master")
    port_trace.reset_tracer()
    try:
        sp = Spool(tmp_path / "spool")
        rec = port_spool.make_request(prompt_len=6, max_new_tokens=3, request_id="t0")
        rec["tctx"]["tx"] = time.time()  # the router's dispatch stamp
        sp.enqueue(rec)
        serve.run(spool_dir=str(sp.root), max_requests=1, idle_timeout=30, log=lambda *_: None, **TINY)
    finally:
        port_trace.reset_tracer()
    (path,) = jax_trace.span_files(tmp_path / "trace")
    assert path.name.startswith("master-0-")
    events = jax_trace.load_span_file(path)
    spans = [e for e in events if e["ph"] == "X"]
    assert sorted(e["name"] for e in spans) == [
        "decode", "enqueue", "respond", "slot_wait", "spool_transit",
    ]
    assert all(e["cat"] == "serve" and e["args"]["rid"] == "t0" for e in spans)
    assert {e["name"] for e in events if e["ph"] == "M"} == {"process_name", "clock_sync"}
    assert [e for e in spans if e["name"] == "decode"][0]["args"]["tokens"] == 3


def test_serve_emits_no_spans_without_trace_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("TPUJOB_TRACE_DIR", raising=False)
    port_trace.reset_tracer()
    assert port_trace.tracer() is None
    sp = Spool(tmp_path / "spool")
    sp.submit(prompt_len=4, max_new_tokens=2)
    stats = serve.run(spool_dir=str(sp.root), max_requests=1, idle_timeout=30, log=lambda *_: None, **TINY)
    assert stats["served"] == 1 and port_trace.tracer() is None
    assert np.isfinite(stats["ttft_ms_p50"])
