"""The port's copy of the multi-process commit protocol
(pytorch_operator_tpu_torch/checkpoint/multihost.py, with the port's
AsyncCheckpointWriter): the cases of tests/test_multihost_ckpt.py, run
against the port's modules. The primary's commit and its per-process writer
barriers, exercised with real processes sharing a checkpoint directory.

Invariants pinned here:

- a step is sidecar-verified ONLY after every process's shard is
  durable (the primary's ``wait_all`` precedes the sidecar);
- a process that never arrives fails the save on every survivor
  (recorded + reported, never raised into the step loop) and the step
  never verifies — restore falls back to the last verified step;
- barriers compose with the async writer's ordering: per-process
  pipelined submits still commit 1, 2, 3... with one sidecar each;
- marker GC: the rendezvous files do not accumulate across steps.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import time
from pathlib import Path

import pytest

from pytorch_operator_tpu_torch.checkpoint import integrity
from pytorch_operator_tpu_torch.checkpoint.async_writer import AsyncCheckpointWriter
from pytorch_operator_tpu_torch.checkpoint.multihost import (
    BARRIER_DIR,
    BarrierTimeout,
    CommitBarrier,
    make_multihost_commit,
)

pytestmark = pytest.mark.chaos


# ---- barrier units ----


class TestCommitBarrier:
    def test_wait_all_returns_once_everyone_arrives(self, tmp_path):
        b0 = CommitBarrier(tmp_path, 0, 2)
        b1 = CommitBarrier(tmp_path, 1, 2)
        b0.arrive("written", 3)
        with pytest.raises(BarrierTimeout):
            b0.wait_all("written", 3, timeout=0.2)
        b1.arrive("written", 3)
        b0.wait_all("written", 3, timeout=2.0)  # no raise
        b1.wait_all("written", 3, timeout=2.0)

    def test_timeout_names_the_missing_processes(self, tmp_path):
        b0 = CommitBarrier(tmp_path, 0, 3)
        b0.arrive("written", 1)
        with pytest.raises(BarrierTimeout, match=r"\[1, 2\]"):
            b0.wait_all("written", 1, timeout=0.2)

    def test_arrive_is_idempotent_and_atomic(self, tmp_path):
        b = CommitBarrier(tmp_path, 0, 1)
        b.arrive("written", 7)
        b.arrive("written", 7)
        markers = list((tmp_path / BARRIER_DIR).iterdir())
        assert [m.name for m in markers] == ["written-7.p0"]

    def test_targeted_wait(self, tmp_path):
        b0 = CommitBarrier(tmp_path, 0, 3)
        b1 = CommitBarrier(tmp_path, 1, 3)
        b0.arrive("committed", 2)
        # Waiting only on the primary succeeds though 2 never arrived.
        b1.wait_all("committed", 2, timeout=1.0, procs=(0,))

    def test_out_of_world_process_id_rejected(self, tmp_path):
        with pytest.raises(ValueError):
            CommitBarrier(tmp_path, 3, 3)


# ---- in-process protocol (writers in threads, shared dir) ----


def _mk_writer(root: Path, pid: int, n: int, timeout: float = 10.0):
    def write_shard(step, payload, fault):
        d = root / str(step)
        d.mkdir(parents=True, exist_ok=True)
        (d / f"shard-{pid}.json").write_text(json.dumps({"p": pid}))

    commit = make_multihost_commit(
        root,
        write_shard,
        process_id=pid,
        num_processes=n,
        barrier_timeout=timeout,
        on_abort=lambda s: (root / str(s) / f"shard-{pid}.json").unlink(
            missing_ok=True
        ),
    )
    # Only the primary's writer owns the shared fence, and a failed
    # barrier must LEAVE it standing (peer shards the primary cannot
    # see may exist — fenced, not torn).
    return AsyncCheckpointWriter(
        commit,
        root=root if pid == 0 else None,
        clear_fence_on_error=False,
    )


class TestMultihostProtocol:
    def test_all_shards_present_before_verify(self, tmp_path):
        N = 3
        writers = [_mk_writer(tmp_path, p, N) for p in range(N)]
        for s in (1, 2, 3):
            for w in writers:
                w.submit(s, None)
        for w in writers:
            assert w.close() is True
        for w in writers:
            assert not w.errors, w.errors
            assert w.committed == [1, 2, 3]  # ordered per process
        for s in (1, 2, 3):
            assert integrity.verify_step(tmp_path, s) is True
            shards = sorted(p.name for p in (tmp_path / str(s)).glob("*"))
            assert shards == [f"shard-{p}.json" for p in range(N)]

    def test_markers_are_garbage_collected(self, tmp_path):
        N = 2
        writers = [_mk_writer(tmp_path, p, N) for p in range(N)]
        for s in range(1, 6):
            for w in writers:
                w.submit(s, None)
        for w in writers:
            w.close()
        leftover = sorted(
            p.name for p in (tmp_path / BARRIER_DIR).iterdir()
        )
        # Only the NEWEST step's committed marker may remain (its
        # consumers are gone; the next commit would sweep it).
        assert leftover == ["committed-5.p0"], leftover

    def test_dead_peer_fails_save_and_step_never_verifies(self, tmp_path):
        """The crash-window invariant: a secondary that never writes its
        shard times out the primary's barrier — the save FAILS (recorded,
        loop survives) and no sidecar ever lands, so restore falls back."""
        # A 2-process world where process 1 simply never runs.
        w0 = _mk_writer(tmp_path, 0, 2, timeout=0.5)
        w0.submit(9, None)
        w0.close()
        assert [s for s, _ in w0.errors] == [9]
        assert isinstance(w0.errors[0][1], BarrierTimeout)
        # Fenced, not torn: the step stays behind its inflight fence
        # (verify False, never "unknown-accepted"), so the verified
        # scan skips it entirely.
        assert integrity.verify_step(tmp_path, 9) is False
        # The aborting process cleaned its shard: no bytes masquerade.
        assert not (tmp_path / "9" / "shard-0.json").exists()
        assert integrity.latest_verified_step(tmp_path) is None

    def test_later_saves_proceed_after_a_failed_barrier(self, tmp_path):
        """A lost rendezvous must not poison the writer: the next save
        (with the peer back) commits and verifies."""
        N = 2
        w0 = _mk_writer(tmp_path, 0, N, timeout=0.6)
        w1 = _mk_writer(tmp_path, 1, N, timeout=10.0)
        w0.submit(1, None)  # peer absent for step 1: fails on w0
        w0.wait()
        assert [s for s, _ in w0.errors] == [1]
        # Step 2: both participate. (w1 never saw step 1 — its first
        # submit is step 2, and the protocol does not require aligned
        # histories, only aligned rendezvous per step.)
        w0.submit(2, None)
        w1.submit(2, None)
        assert w0.close() is True
        assert w1.close() is True
        assert integrity.latest_verified_step(tmp_path) == 2


# ---- real multi-process dryrun ----


def _proc_main(root: str, pid: int, n: int, steps: int, die_at):
    """One 'host' of the dryrun world: pipelined async submits through
    the shared-barrier commit. ``die_at=(step, pid)`` kills THIS process
    mid-protocol (before its shard write) to model a crashed host."""
    root = Path(root)

    def write_shard(step, payload, fault):
        if die_at is not None and die_at == [step, pid]:
            import os

            os._exit(137)  # SIGKILL analog: no cleanup, no barrier exit
        d = root / str(step)
        d.mkdir(parents=True, exist_ok=True)
        (d / f"shard-{pid}.json").write_text(json.dumps({"p": pid}))

    commit = make_multihost_commit(
        root, write_shard, process_id=pid, num_processes=n,
        barrier_timeout=5.0,
        on_abort=lambda s: (root / str(s) / f"shard-{pid}.json").unlink(
            missing_ok=True
        ),
    )
    w = AsyncCheckpointWriter(
        commit,
        root=root if pid == 0 else None,
        clear_fence_on_error=False,
    )
    for s in range(1, steps + 1):
        w.submit(s, None)
    w.close()
    # Report what this process saw on its own status line.
    (root / f"result-{pid}.json").write_text(
        json.dumps(
            {
                "committed": w.committed,
                "errors": [s for s, _ in w.errors],
            }
        )
    )


def _spawn_world(root: Path, n: int, steps: int, die_at=None):
    ctx = mp.get_context("spawn")  # clean interpreters: the real shape
    procs = [
        ctx.Process(
            target=_proc_main,
            args=(str(root), pid, n, steps, die_at),
        )
        for pid in range(n)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 60
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    return procs


def test_the_copy_is_the_jax_module_line_for_line():
    """Below its docstring, the port's multihost.py is the JAX package's
    but for the module path of the writer it names."""
    root = Path(__file__).resolve().parents[1]
    strip = lambda p: p.read_text().split("from __future__", 1)[1]  # noqa: E731
    port = strip(root / "pytorch_operator_tpu_torch/checkpoint/multihost.py")
    jax_side = strip(root / "pytorch_operator_tpu/checkpoint/multihost.py")
    assert port == jax_side.replace(
        "pytorch_operator_tpu.checkpoint.async_writer", "pytorch_operator_tpu_torch.checkpoint.async_writer"
    )


def test_multiprocess_dryrun_commits_and_verifies(tmp_path):
    """The acceptance dryrun: 3 real processes, 3 pipelined saves each,
    every step ends with all shards present and sidecar-verified."""
    procs = _spawn_world(tmp_path, n=3, steps=3)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    for pid in range(3):
        res = json.loads((tmp_path / f"result-{pid}.json").read_text())
        assert res["committed"] == [1, 2, 3]
        assert res["errors"] == []
    for s in (1, 2, 3):
        assert integrity.verify_step(tmp_path, s) is True
        assert len(list((tmp_path / str(s)).glob("shard-*.json"))) == 3


def test_multiprocess_dryrun_killed_host_fences_the_step(tmp_path):
    """Kill host 2 before its step-2 shard write: step 1 stays
    verified, step 2 never verifies (every survivor's barrier fails and
    reports), and recovery falls back to step 1."""
    procs = _spawn_world(tmp_path, n=3, steps=3, die_at=[2, 2])
    assert procs[2].exitcode == 137
    res0 = json.loads((tmp_path / "result-0.json").read_text())
    assert res0["committed"] == [1]
    assert 2 in res0["errors"]
    assert integrity.verify_step(tmp_path, 1) is True
    assert integrity.verify_step(tmp_path, 2) is not True
    assert integrity.latest_verified_step(tmp_path) == 1
