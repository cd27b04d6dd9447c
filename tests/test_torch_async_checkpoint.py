"""The port's asynchronous checkpointing (pytorch_operator_tpu_torch/
checkpoint/async_writer.py and ``CheckpointManager.save(block=False)``), on
the CPU: the JAX package's writer tests (tests/test_async_checkpoint.py)
ported, and the manager's asynchronous path.

- The writer: one commit thread in submission order; ``wait``/``close``
  barriers; the ``<step>.inflight`` fence from submit to sidecar;
  ``max_pending`` backpressure; a failed commit or snapshot recorded while
  later saves proceed; staged and eager submissions in one order.
- The manager: asynchronous steps verify and restore; an in-place update
  made after ``save(block=False)`` returns never reaches the committed step,
  in both flavours (on the CPU ``.cpu()`` of a CPU tensor is the tensor
  itself, so the snapshot must copy); ``torn`` and ``enospc`` faults inside
  an asynchronous commit; ``checkpoint_committed`` and
  ``checkpoint_save_failed`` records in the JAX format; the JAX reconciler's
  ``latest_verified_step`` reading asynchronous port steps, a fenced one
  skipped.
- ``llama_train.run`` with ``async_checkpoint`` commits the same bytes as a
  blocking run.

No test here times a race: each asserts order, bytes and records.
"""

import json
import threading
import time
from pathlib import Path

import pytest
import torch

from pytorch_operator_tpu.checkpoint import integrity as jax_integrity
from pytorch_operator_tpu_torch import faults as port_faults
from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, integrity
from pytorch_operator_tpu_torch.checkpoint.async_writer import (
    AsyncCheckpointWriter,
    snapshot_to_host,
    stage_mutable_leaves,
)
from pytorch_operator_tpu_torch.workloads import llama_train


def _json_commit(root: Path, delay: float = 0.0, order=None):
    def commit(step, payload, fault):
        if fault == "fail":
            raise OSError("injected")
        d = root / str(step)
        d.mkdir(parents=True, exist_ok=True)
        (d / "state.json").write_text(json.dumps({"step": step}))
        if delay:
            time.sleep(delay)
        integrity.write_sidecar(root, step)
        if order is not None:
            order.append(step)

    return commit


@pytest.fixture
def plan(monkeypatch):
    def arm(*faults):
        monkeypatch.setenv("TPUJOB_FAULT_PLAN", json.dumps({"faults": list(faults)}))
        port_faults.reset()

    yield arm
    port_faults.reset()


@pytest.fixture
def status(monkeypatch, tmp_path):
    d = tmp_path / "status"
    d.mkdir()
    monkeypatch.setenv("TPUJOB_STATUS_DIR", str(d))
    monkeypatch.setenv("TPUJOB_REPLICA_TYPE", "Master")
    monkeypatch.setenv("TPUJOB_REPLICA_INDEX", "0")

    def records():
        path = d / "master-0.jsonl"
        return [json.loads(x) for x in path.read_text().splitlines()] if path.exists() else []

    return records


# ---- the writer ----


def test_commits_serialize_in_submission_order(tmp_path):
    order = []
    w = AsyncCheckpointWriter(_json_commit(tmp_path, delay=0.02, order=order), root=tmp_path)
    for s in range(1, 6):
        w.submit(s, None)
    w.close()
    assert order == [1, 2, 3, 4, 5] and w.committed == [1, 2, 3, 4, 5]
    assert w.last_committed_step() == 5


def test_wait_drains_and_close_refuses_further_submits(tmp_path):
    w = AsyncCheckpointWriter(_json_commit(tmp_path, delay=0.05), root=tmp_path)
    w.submit(1, None)
    w.submit(2, None)
    assert w.pending()
    assert w.wait(10.0) is True
    assert not w.pending() and integrity.verify_step(tmp_path, 2) is True
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(3, None)


def test_wait_returns_false_on_timeout_and_close_warns(tmp_path, capsys):
    release = threading.Event()

    def commit(step, payload, fault):
        release.wait(10)

    w = AsyncCheckpointWriter(commit, root=tmp_path)
    w.submit(1, None)
    assert w.wait(0.05) is False
    assert w.close(timeout=0.05) is False
    assert "drain timed out" in capsys.readouterr().out
    release.set()


def test_failed_commit_recorded_and_later_saves_proceed(tmp_path):
    errs = []
    w = AsyncCheckpointWriter(_json_commit(tmp_path), root=tmp_path, on_error=lambda s, e: errs.append(s))
    w.submit(1, None)
    w.submit(2, None, fault="fail")
    w.submit(3, None)
    w.close()
    assert [s for s, _ in w.errors] == [2] and errs == [2]
    assert w.committed == [1, 3]
    assert not integrity.inflight_path(tmp_path, 2).exists()
    assert integrity.latest_verified_step(tmp_path) == 3


def test_inflight_fence_lifecycle(tmp_path):
    """The fence is on disk from submit until the sidecar lands; a fenced
    step verifies as uncommitted (False), never as unknown — also to the JAX
    package's integrity module, which the supervisor's reconciler runs."""
    gate = threading.Event()
    written = threading.Event()

    def commit(step, payload, fault):
        d = tmp_path / str(step)
        d.mkdir(parents=True, exist_ok=True)
        (d / "state.json").write_text("{}")
        written.set()
        gate.wait(10)  # held mid-commit: state written, no sidecar yet
        integrity.write_sidecar(tmp_path, step)

    w = AsyncCheckpointWriter(commit, root=tmp_path)
    w.submit(7, None)
    assert written.wait(10)
    assert integrity.inflight_path(tmp_path, 7).exists()
    assert integrity.verify_step(tmp_path, 7) is False
    assert jax_integrity.verify_step(tmp_path, 7) is False
    gate.set()
    w.close()
    assert not integrity.inflight_path(tmp_path, 7).exists()
    assert integrity.verify_step(tmp_path, 7) is True


def test_backpressure_bounds_pending_snapshots(tmp_path):
    """With ``max_pending=2`` the third submit blocks until a commit frees a
    slot."""
    release = threading.Event()
    w = AsyncCheckpointWriter(lambda s, p, f: release.wait(10), root=tmp_path, max_pending=2)
    w.submit(1, None)
    w.submit(2, None)
    entered, returned = threading.Event(), threading.Event()

    def third():
        entered.set()
        w.submit(3, None)
        returned.set()

    t = threading.Thread(target=third, daemon=True)
    t.start()
    assert entered.wait(10)
    assert not returned.wait(0.2)  # blocked on the slot
    assert w.stats()["queue_depth"] == 2
    release.set()
    t.join(10)
    assert returned.is_set() and not t.is_alive()
    w.close()
    assert w.committed == [1, 2, 3]


def test_staged_and_eager_submits_keep_one_order(tmp_path):
    order = []
    w = AsyncCheckpointWriter(_json_commit(tmp_path, delay=0.01, order=order), root=tmp_path)
    w.submit(1, None)
    w.submit_staged(2, lambda: None)
    w.submit(3, None)
    w.submit_staged(4, lambda: None)
    w.close()
    assert order == [1, 2, 3, 4] and w.committed == [1, 2, 3, 4]


def test_staged_submit_returns_before_its_snapshot_runs(tmp_path):
    started, release = threading.Event(), threading.Event()

    def slow_snapshot():
        started.set()
        release.wait(10)
        return {"s": 7}

    w = AsyncCheckpointWriter(_json_commit(tmp_path), root=tmp_path)
    w.submit_staged(7, slow_snapshot)
    assert integrity.inflight_path(tmp_path, 7).exists()
    assert started.wait(10)
    assert w.stats()["snapshot_depth"] == 1
    release.set()
    w.close()
    assert integrity.verify_step(tmp_path, 7) is True and w.stats()["snapshot_depth"] == 0


def test_failed_snapshot_recorded_fence_cleared_later_saves_proceed(tmp_path):
    errs = []

    def boom():
        raise RuntimeError("snapshot failed")

    w = AsyncCheckpointWriter(_json_commit(tmp_path), root=tmp_path, on_error=lambda s, e: errs.append(s))
    w.submit_staged(1, lambda: None)
    w.submit_staged(2, boom)
    w.submit_staged(3, lambda: None)
    w.close()
    assert [s for s, _ in w.errors] == [2] and errs == [2] and w.committed == [1, 3]
    assert not integrity.inflight_path(tmp_path, 2).exists()


def test_snapshots_own_their_bytes():
    """Both flavours copy: an in-place update after the call does not reach
    the snapshot (a CPU tensor's ``.cpu()`` would be the tensor itself)."""
    src = {"w": torch.ones(4, 4), "n": 3, "nested": [torch.zeros(2)]}
    eager = snapshot_to_host(src)
    staged = stage_mutable_leaves(src)
    src["w"].fill_(7.0)
    src["nested"][0].add_(1.0)
    for snap in (eager, staged()):
        assert torch.equal(snap["w"], torch.ones(4, 4)) and snap["n"] == 3
        assert torch.equal(snap["nested"][0], torch.zeros(2))
        assert snap["w"].data_ptr() != src["w"].data_ptr()


# ---- the manager ----


def _state(v: float):
    return {"params": {"w": torch.full((64, 32), v), "b": torch.zeros(3)}, "opt_state": {"count": int(v)}}


@pytest.mark.parametrize("staged", [False, True], ids=["eager", "staged"])
def test_async_steps_verify_and_restore(tmp_path, staged):
    with CheckpointManager(tmp_path / "ck", max_to_keep=10, staged=staged) as mgr:
        mgr.save(1, _state(1.0), block=False)
        mgr.save(2, _state(2.0), block=False)
        assert mgr.latest_verified_step() == 2  # the read side drains
        assert integrity.verify_step(tmp_path / "ck", 1) is True
        step, st = mgr.restore_or_none({"params": {}, "opt_state": {}})
    assert step == 2 and torch.equal(st["params"]["w"], torch.full((64, 32), 2.0))
    assert st["opt_state"]["count"] == 2


@pytest.mark.parametrize("staged", [False, True], ids=["eager", "staged"])
def test_snapshot_isolates_from_inplace_update(tmp_path, staged):
    """The port's step updates the state in place: what the next step does
    after ``save(block=False)`` returns must not reach the committed step."""
    state = {"params": {"w": torch.full((64, 32), 5.0)}}
    with CheckpointManager(tmp_path / "ck", staged=staged) as mgr:
        mgr.save(1, state, block=False)
        state["params"]["w"].fill_(-1.0)  # the next step, in place
        step, st = mgr.restore_or_none({"params": {}})
    assert step == 1 and torch.equal(st["params"]["w"], torch.full((64, 32), 5.0))


def test_per_call_flavour_overrides_the_managers(tmp_path):
    with CheckpointManager(tmp_path / "ck", max_to_keep=10, staged=True) as mgr:
        mgr.save(1, _state(1.0), block=False, staged=False)
        mgr.save(2, _state(2.0), block=False)
        mgr.save(3, _state(3.0))  # blocking, after draining the two
        assert mgr.all_steps() == [1, 2, 3] and mgr.latest_verified_step() == 3
        assert mgr.last_committed_step() == 2


def test_torn_fault_fires_inside_an_async_commit(tmp_path, plan):
    plan({"kind": "torn_checkpoint_write", "nth": 2})
    with CheckpointManager(tmp_path / "ck", max_to_keep=10) as mgr:
        mgr.save(1, _state(1.0), block=False)
        mgr.save(2, _state(2.0), block=False)
        assert mgr.latest_verified_step() == 1  # 2 committed torn, caught
        step, _ = mgr.restore_or_none({"params": {}, "opt_state": {}})
    assert step == 1


def test_enospc_async_commit_reported_not_raised(tmp_path, plan, status):
    """A save lost to a full disk does not stop the step loop: it is recorded
    on the writer and reported as ``checkpoint_save_failed``; the later save
    lands; restore falls back to the last verified step. Every commit writes
    a ``checkpoint_committed`` record with the JAX package's fields."""
    plan({"kind": "enospc_checkpoint_write", "nth": 2})
    with CheckpointManager(tmp_path / "ck", max_to_keep=10) as mgr:
        mgr.save(1, _state(1.0), block=False)
        mgr.save(2, _state(2.0), block=False)  # lost to ENOSPC
        mgr.save(3, _state(3.0), block=False)
        assert mgr.wait() is True
        assert [s for s, _ in mgr._writer.errors] == [2]
        assert mgr.all_steps() == [1, 3] and mgr.latest_verified_step() == 3
        assert not integrity.inflight_path(tmp_path / "ck", 2).exists()
    recs = status()
    failed = [r for r in recs if r["event"] == "checkpoint_save_failed"]
    assert [r["step"] for r in failed] == [2] and "no space left" in failed[0]["error"]
    committed = [r for r in recs if r["event"] == "checkpoint_committed"]
    assert [r["step"] for r in committed] == [1, 3]
    for r in committed:
        assert set(r) == {"event", "ts", "step", "commit_ms", "queue_depth", "oldest_age_s", "stage_depth"}
        assert r["commit_ms"] > 0


def test_checkpoint_committed_record_matches_the_jax_writer(monkeypatch, tmp_path):
    """The port's record and the JAX package's, written for the same commit,
    hold the same fields and values."""
    from pytorch_operator_tpu.runtime import rendezvous as jax_rendezvous
    from pytorch_operator_tpu_torch.runtime import rendezvous

    monkeypatch.setenv("TPUJOB_STATUS_DIR", str(tmp_path))
    monkeypatch.setenv("TPUJOB_REPLICA_TYPE", "Worker")
    monkeypatch.setenv("TPUJOB_REPLICA_INDEX", "1")
    rendezvous.report_checkpoint_committed(8, 0.25, 1, 0.5, 1)
    jax_rendezvous.report_checkpoint_committed(8, 0.25, 1, 0.5, 1)
    port, ref = (json.loads(x) for x in (tmp_path / "worker-1.jsonl").read_text().splitlines())
    port.pop("ts"), ref.pop("ts")
    assert port == ref


def test_jax_reconciler_probe_reads_async_port_steps(tmp_path):
    """The supervisor's probe (the JAX ``integrity.latest_verified_step``)
    reads asynchronously committed port steps, and skips a fenced one: a
    commit held mid-way, as a preempted process leaves it."""
    root = tmp_path / "ck"
    with CheckpointManager(root, max_to_keep=10) as mgr:
        mgr.save(2, _state(2.0), block=False)
        mgr.save(4, _state(4.0), block=False)
        mgr.wait()
    assert jax_integrity.latest_verified_step(root) == 4
    # A later life's commit of step 6 that never finished: whole bytes,
    # no sidecar, the fence still on disk.
    (root / "6").mkdir()
    for name in ("params.pt", "opt_state.pt", "meta.json"):
        (root / "6" / name).write_bytes((root / "4" / name).read_bytes())
    integrity.mark_inflight(root, 6)
    assert jax_integrity.latest_verified_step(root) == 4
    assert CheckpointManager(root, create=False).restore_or_none({"params": {}})[0] == 4


def test_llama_train_async_commits_the_blocking_runs_bytes(tmp_path, monkeypatch, status):
    """``llama_train.run(async_checkpoint=True)``: every in-loop step is
    committed with its sidecar and verified, one ``checkpoint_committed``
    record a save, and each step's tensors equal a blocking run's bit for
    bit (the same training, the snapshot taken before the next in-place
    update)."""
    kw = dict(config="tiny", batch_size=4, seq_len=32, steps=6, warmup=1, checkpoint_every=2,
              device="cpu", log=lambda m: None)
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", str(tmp_path / "blocking"))
    blocking = llama_train.run(**kw)
    n_blocking = len(status())
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", str(tmp_path / "async"))
    asynch = llama_train.run(async_checkpoint=True, **kw)
    assert asynch["losses"] == blocking["losses"] and len(asynch["save_s"]) == 3
    committed = [r for r in status()[n_blocking:] if r["event"] == "checkpoint_committed"]
    assert [r["step"] for r in committed] == [2, 4, 6]
    a = CheckpointManager(tmp_path / "async", create=False, max_to_keep=10)
    b = CheckpointManager(tmp_path / "blocking", create=False, max_to_keep=10)
    assert a.all_steps() == b.all_steps() == [4, 6, 7]
    for step in (4, 6, 7):
        assert integrity.verify_step(tmp_path / "async", step) is True
        sa, sb = a.restore({"params": {}, "opt_state": {}}, step), b.restore({"params": {}, "opt_state": {}}, step)
        for name, t in sb["params"].items():
            assert torch.equal(sa["params"][name], t), (step, name)
        for i, st in sb["opt_state"]["adamw"]["state"].items():
            for key, t in st.items():
                assert torch.equal(sa["opt_state"]["adamw"]["state"][i][key], t), (step, i, key)
