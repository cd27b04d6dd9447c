"""The port's checkpoint manager (pytorch_operator_tpu_torch/checkpoint/) and
its checkpoint-write fault site, on the CPU.

- A save restores bit for bit (weights and AdamW state), keeps
  ``max_to_keep`` steps with their sidecars, and a ``params``-only restore
  never opens ``opt_state.pt``.
- The ``fail``, ``enospc`` and ``torn`` faults of ``TPUJOB_FAULT_PLAN`` act
  as in the JAX package (retried, lost and cleaned, committed corrupt), and
  a chaos plan fires on the same saves in both packages.
- A corrupt newest step falls back to the older one with a
  ``checkpoint_corrupt`` record.
- The JAX package's own ``integrity.latest_verified_step``, which the
  supervisor's reconciler calls on a job's checkpoint directory
  (controller/reconciler.py), reads a port checkpoint directory: the newest
  step, then the older one after ``corrupt_step``.
"""

import errno
import json

import pytest
import torch

from pytorch_operator_tpu.checkpoint import integrity as jax_integrity
from pytorch_operator_tpu.faults import injector as jax_injector
from pytorch_operator_tpu.faults.plan import FaultPlan
from pytorch_operator_tpu_torch import faults as port_faults
from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, integrity
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.workloads import llama_train, trainer


def _trained_state(seed: int = 0):
    """A tiny model and its AdamW after one step: every kind of tensor a
    training checkpoint holds."""
    model = port_llama.Llama(port_llama.llama_tiny()).init_weights(
        torch.Generator().manual_seed(seed)
    )
    opt = trainer.make_optimizer(model.parameters(), 1e-3, schedule="cosine", decay_steps=10)
    step = trainer.make_lm_train_step(model, opt)
    step(torch.from_numpy(llama_train.synthetic_bigram_batch(2, 16, 256, seed)).long())
    return model, opt


def _state(model, opt):
    return {"params": model.state_dict(), "opt_state": opt.state_dict()}


def _small(v: float):
    return {"params": {"w": torch.full((8, 4), v), "b": torch.zeros(4)}}


@pytest.fixture
def plan(monkeypatch):
    """Arm a fault plan through ``TPUJOB_FAULT_PLAN``, as the supervisor
    threads it into a replica."""

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


def test_round_trip_is_bit_exact(tmp_path):
    model, opt = _trained_state()
    with CheckpointManager(tmp_path / "ck") as mgr:
        mgr.save(7, _state(model, opt))
        assert mgr.all_steps() == [7] and mgr.latest_verified_step() == 7
        fresh, fresh_opt = _trained_state(seed=1)
        step, restored = mgr.restore_or_none(_state(fresh, fresh_opt))
    assert step == 7
    fresh.load_state_dict(restored["params"])
    fresh_opt.load_state_dict(restored["opt_state"])
    for name, t in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], t), name
    assert fresh_opt.count == opt.count == 1
    a, b = opt.adamw.state_dict(), fresh_opt.adamw.state_dict()
    for i, st in a["state"].items():
        for key, t in st.items():
            assert torch.equal(b["state"][i][key], t), (i, key)
    assert sorted(p.name for p in (tmp_path / "ck" / "7").iterdir()) == [
        "meta.json", "opt_state.pt", "params.pt",
    ]
    meta = json.loads((tmp_path / "ck" / "7" / "meta.json").read_text())
    assert meta == {"step": 7, "keys": ["opt_state", "params"], "format": "torch.save"}


def test_restore_checks_names_and_shapes(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, _small(1.0))
    with pytest.raises(ValueError, match="first mismatch at w"):
        mgr.restore({"params": {"w": torch.zeros(8, 5), "b": torch.zeros(4)}})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "missing", create=False)
    assert not (tmp_path / "missing").exists()
    # An asynchronous save (ported in slice 8) restores under the same check.
    mgr.save(2, _small(2.0), block=False)
    assert mgr.latest_verified_step() == 2
    with pytest.raises(ValueError, match="first mismatch at w"):
        mgr.restore({"params": {"w": torch.zeros(8, 5), "b": torch.zeros(4)}})
    mgr.close()


def test_retention_keeps_max_to_keep_with_their_sidecars(tmp_path):
    root = tmp_path / "ck"
    with CheckpointManager(root, max_to_keep=2) as mgr:
        for s in (1, 2, 3, 4):
            mgr.save(s, _small(float(s)))
        assert mgr.all_steps() == [3, 4]
    assert sorted(p.name for p in root.iterdir()) == ["3", "3.digest", "4", "4.digest"]


def test_restore_subtree_reads_params_only(tmp_path, monkeypatch):
    model, opt = _trained_state()
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(3, _state(model, opt))
    opened = []
    real_load = torch.load

    def spy(path, *a, **k):
        opened.append(str(path).rsplit("/", 1)[-1])
        return real_load(path, *a, **k)

    monkeypatch.setattr(torch, "load", spy)
    (tmp_path / "ck" / "3" / "opt_state.pt").write_bytes(b"not a checkpoint")
    step, params = mgr.restore_subtree("params")
    assert step == 3 and opened == ["params.pt"]
    assert all(torch.equal(params[k], v) for k, v in model.state_dict().items())
    with pytest.raises(KeyError, match="no top-level 'missing'"):
        mgr.restore_subtree("missing")


def test_transient_fail_is_retried(tmp_path, plan):
    plan({"kind": "fail_checkpoint_write", "nth": 2})
    with CheckpointManager(tmp_path / "ck") as mgr:
        mgr.save(1, _small(1.0))
        mgr.save(2, _small(2.0))  # first attempt fails, the retry lands
        assert mgr.all_steps() == [1, 2] and mgr.latest_verified_step() == 2
    assert [p.name for p in (tmp_path / "ck").iterdir() if p.name.startswith(".")] == []


def test_enospc_raises_and_leaves_no_partial_step(tmp_path, plan):
    plan({"kind": "enospc_checkpoint_write", "nth": 2})
    root = tmp_path / "ck"
    with CheckpointManager(root) as mgr:
        mgr.save(1, _small(1.0))
        with pytest.raises(OSError) as ei:
            mgr.save(2, _small(2.0))
        assert ei.value.errno == errno.ENOSPC
        assert sorted(p.name for p in root.iterdir()) == ["1", "1.digest"]
        mgr.save(3, _small(3.0))  # the loop survives: the next save lands
        assert mgr.latest_verified_step() == 3


def test_torn_write_commits_corrupt_and_restore_falls_back(tmp_path, plan, status):
    plan({"kind": "torn_checkpoint_write", "nth": 2})
    with CheckpointManager(tmp_path / "ck") as mgr:
        mgr.save(1, _small(1.0))
        mgr.save(2, _small(2.0))
        assert mgr.all_steps() == [1, 2]
        assert integrity.verify_step(tmp_path / "ck", 2) is False
        step, state = mgr.restore_or_none(_small(0.0))
    assert step == 1 and torch.equal(state["params"]["w"], torch.full((8, 4), 1.0))
    corrupt = [r for r in status() if r["event"] == "checkpoint_corrupt"]
    assert [(r["step"], r["fallback"]) for r in corrupt] == [(2, 1)]


def test_fault_plan_fires_on_the_same_saves_as_jax(monkeypatch):
    """One plan, eight saves, this replica and another's faults: the port's
    site returns the JAX site's mode at every occurrence."""
    faults = [
        {"kind": "fail_checkpoint_write", "nth": 2},
        {"kind": "torn_checkpoint_write", "nth": 3, "times": 2, "target": "master-0"},
        {"kind": "enospc_checkpoint_write", "nth": 4, "target": "worker-1"},
        {"kind": "enospc_checkpoint_write", "nth": 6, "restart": 1},
        {"kind": "fail_checkpoint_write", "nth": 7, "restart": 0},
    ]
    monkeypatch.setenv("TPUJOB_FAULT_PLAN", json.dumps({"faults": faults}))
    for rtype, restart in (("Master", 0), ("Master", 1), (None, None)):
        if rtype is None:
            monkeypatch.delenv("TPUJOB_REPLICA_TYPE", raising=False)
        else:
            monkeypatch.setenv("TPUJOB_REPLICA_TYPE", rtype)
            monkeypatch.setenv("TPUJOB_REPLICA_INDEX", "0")
            monkeypatch.setenv("TPUJOB_RESTART_COUNT", str(restart))
        port_faults.reset()
        jax = jax_injector.FaultInjector(FaultPlan.from_env())
        ident = (rtype, None if rtype is None else 0, restart)
        want = [jax.checkpoint_write_fault(*ident) for _ in range(8)]
        got = [port_faults.checkpoint_write_fault() for _ in range(8)]
        assert got == want, (rtype, restart)
    assert want == [None, "fail", "torn", "torn", None, "enospc", "fail", None]
    port_faults.reset()


def test_corrupt_step_falls_back_with_a_record(tmp_path, status):
    root = tmp_path / "ck"
    with CheckpointManager(root) as mgr:
        mgr.save(1, _small(1.0))
        mgr.save(2, _small(2.0))
        integrity.corrupt_step(root, 2)
        assert mgr.latest_verified_step() == 1
        step, _ = mgr.restore_or_none(_small(0.0))
        assert step == 1
        # A step without a sidecar whose file torch.load rejects falls back too.
        integrity.sidecar_path(root, 2).unlink()
        (root / "2" / "params.pt").write_bytes(b"\x00" * 16)
        step, _ = mgr.restore_or_none(_small(0.0))
        assert step == 1
        # A resumed run saving step 2 again replaces the bad bytes.
        mgr.save(2, _small(2.5))
        step, state = mgr.restore_or_none(_small(0.0))
        assert step == 2 and float(state["params"]["w"][0, 0]) == 2.5
    recs = [r for r in status() if r["event"] == "checkpoint_corrupt"]
    assert [r["step"] for r in recs] == [2, 2, 2] and {r["fallback"] for r in recs} == {1}


def test_jax_reconciler_probe_reads_port_checkpoints(tmp_path):
    """``integrity.latest_verified_step`` of the JAX package on a directory
    the port wrote: what the reconciler reads when it decides where a
    restarted job resumes."""
    model, opt = _trained_state()
    root = tmp_path / "ck"
    with CheckpointManager(root) as mgr:
        for s in (80, 82):
            mgr.save(s, _state(model, opt))
    assert jax_integrity.list_steps(root) == [80, 82]
    assert jax_integrity.verify_step(root, 82) is True
    assert jax_integrity.latest_verified_step(root) == 82
    assert jax_integrity.step_digest(root / "82") == integrity.step_digest(root / "82")
    integrity.corrupt_step(root, 82)
    skipped = []
    assert jax_integrity.latest_verified_step(root, on_corrupt=skipped.append) == 80
    assert skipped == [82]
