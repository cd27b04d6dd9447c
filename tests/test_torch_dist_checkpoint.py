"""Checkpoints of the port's multi-process training (``checkpoint/manager.py``
with ``num_processes`` > 1), on the CPU in two-rank gloo worlds.

- A two-rank ``fsdp=2`` run saves once asynchronously (step 3) and once
  blocking (its final step 4): each rank writes its own files of a step, the
  primary ``meta.json`` and, after every rank's files, the sidecar; the JAX
  package's reconciler probe reads the steps.
- One process restores the step: its parameters equal the ranks' gathered
  parameters bit for bit. Two ranks restore it into ``fsdp=2``, each
  reading only its own rows.
- From step 3, a two-rank ``fsdp=2`` resume gives the uninterrupted run's
  step-4 loss bit for bit; resumes at another layout (one process, and
  ``dp=2``) give it within rtol 1e-5 (the same global batch, its gradient
  summed in another order).
- A one-process save restores into a two-rank world.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_operator_tpu.checkpoint import integrity as jax_integrity
from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, integrity
from pytorch_operator_tpu_torch.workloads import llama_train
from tests import torch_worlds

KW = dict(config="tiny", batch_size=8, seq_len=32, lr=1e-3, seed=3)


def _keep_only(src: Path, dst: Path, step: int) -> Path:
    """A copy of checkpoint root ``src`` holding ``step`` alone."""
    dst.mkdir()
    shutil.copytree(src / str(step), dst / str(step))
    shutil.copy(integrity.sidecar_path(src, step), integrity.sidecar_path(dst, step))
    return dst


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The uninterrupted two-rank run (warmup 1 + 3 steps, async saves every
    3, the final save blocking), its checkpoint root and result."""
    ck = tmp_path_factory.mktemp("dist_ck") / "ck"
    (r0, r1), = zip(*torch_worlds.run_world("train", [dict(
        KW, mesh_spec="fsdp=2", warmup=1, steps=3, checkpoint_every=3, async_checkpoint=True,
        env={"TPUJOB_CHECKPOINT_DIR": str(ck)},
    )]))
    return ck, r0, r1


def test_each_rank_writes_its_files_and_the_primary_commits(saved):
    ck, r0, r1 = saved
    assert r0["end_step"] == 4 and len(r0["save_s"]) == 1  # the async save at 3
    assert sorted(p.name for p in ck.iterdir()) == [".barriers", "3", "3.digest", "4", "4.digest"]
    for step in (3, 4):
        files = sorted(p.name for p in (ck / str(step)).iterdir())
        assert files == ["meta.json", "opt_state.r0.pt", "opt_state.r1.pt", "params.r0.pt",
                         "params.r1.pt"]
        meta = json.loads((ck / str(step) / "meta.json").read_text())
        assert meta["world"] == 2 and meta["step"] == step
        assert integrity.verify_step(ck, step) is True
    assert not list(ck.glob("*.inflight"))
    # The supervisor's probe (the JAX package's reconciler reads this).
    assert jax_integrity.latest_verified_step(ck) == 4


def test_one_process_restores_the_gathered_parameters_bit_for_bit(saved):
    ck, r0, r1 = saved
    step, params = CheckpointManager(ck, create=False).restore_subtree("params")
    assert step == 4 and params.keys() == r0["params"].keys()
    for name, t in params.items():
        np.testing.assert_array_equal(t.numpy(), r0["params"][name], err_msg=name)
        np.testing.assert_array_equal(t.numpy(), r1["params"][name], err_msg=name)


def test_each_rank_restores_its_rows_from_its_own_file(saved):
    """A two-rank fsdp=2 restore of an fsdp=2 step: each rank's rows equal
    the gathered parameters' and come from its own file alone (another
    rank's records are blinded, and a whole-tensor restore under the same
    blinding raises, so the check can fail)."""
    ck, r0, _ = saved
    ranks = torch_worlds.run_world("restore_own_rows", str(ck), 4)
    for r, got in enumerate(ranks):
        assert got["whole_raised"], r
        assert got["rows"].keys() == r0["params"].keys()
        for name, (offset, rows) in got["rows"].items():
            whole = r0["params"][name]
            assert offset == r * -(-whole.shape[0] // 2), (r, name)
            np.testing.assert_array_equal(rows, whole[offset : offset + rows.shape[0]], err_msg=name)


def test_resume_at_the_same_and_other_layouts(saved, tmp_path):
    ck, r0, _ = saved
    want = r0["losses"][3]  # the uninterrupted run's step 4
    resume = dict(KW, warmup=1, steps=5, max_steps=4, checkpoint_every=100)
    roots = {name: _keep_only(ck, tmp_path / name, 3) for name in ("fsdp", "dp", "one")}
    fsdp, dp = torch_worlds.run_world("train", [
        dict(resume, mesh_spec="fsdp=2", env={"TPUJOB_CHECKPOINT_DIR": str(roots["fsdp"])}),
        dict(resume, mesh_spec="dp=2", env={"TPUJOB_CHECKPOINT_DIR": str(roots["dp"])}),
    ])[0]
    assert fsdp["end_step"] == dp["end_step"] == 4
    assert fsdp["losses"] == [want]
    np.testing.assert_allclose(dp["losses"], [want], rtol=1e-5)
    import os

    os.environ["TPUJOB_CHECKPOINT_DIR"] = str(roots["one"])
    try:
        one = llama_train.run(device="cpu", log=lambda m: None, **resume)
    finally:
        del os.environ["TPUJOB_CHECKPOINT_DIR"]
    assert one["end_step"] == 4
    np.testing.assert_allclose(one["losses"], [want], rtol=1e-5)


def test_a_one_process_save_restores_in_two_ranks(tmp_path, monkeypatch):
    """One process trains 2 steps and saves; a two-rank fsdp=2 world resumes
    from it and the one process continues alike."""
    ck = tmp_path / "one"
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", str(ck))
    first = llama_train.run(device="cpu", log=lambda m: None, warmup=1, steps=1,
                            checkpoint_every=100, **KW)
    assert first["end_step"] == 2 and sorted(p.name for p in (ck / "2").iterdir()) == [
        "meta.json", "opt_state.pt", "params.pt",
    ]
    two_root = _keep_only(ck, tmp_path / "two", 2)
    resume = dict(KW, warmup=1, steps=5, max_steps=3, checkpoint_every=100)
    (two,), _ = torch_worlds.run_world("train", [dict(
        resume, mesh_spec="fsdp=2", env={"TPUJOB_CHECKPOINT_DIR": str(two_root)},
    )])
    one = llama_train.run(device="cpu", log=lambda m: None, **resume)
    assert two["end_step"] == one["end_step"] == 3
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)


def test_a_step_another_rank_is_writing_is_no_step_yet(tmp_path):
    """Every rank must see the same steps: a step the primary has fenced and
    begun to write is not listed by a secondary (else the secondary could
    skip the final save the primary is waiting for), and appears for both
    once the sidecar commits it."""
    primary, secondary = (CheckpointManager(tmp_path, process_id=r, num_processes=2) for r in (0, 1))
    integrity.mark_inflight(tmp_path, 4)
    (tmp_path / "4").mkdir()
    assert primary.all_steps() == secondary.all_steps() == []
    assert secondary.latest_step() is None
    integrity.write_sidecar(tmp_path, 4)
    assert primary.all_steps() == secondary.all_steps() == [4]
    # One process keeps the single-writer listing.
    assert CheckpointManager(tmp_path).all_steps() == [4]
