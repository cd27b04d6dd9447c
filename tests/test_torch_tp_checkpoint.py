"""Checkpoints across layouts: a step written by a world of one layout
(``tp=2``, ``fsdp=2``, ``fsdp=2,tp=2``; adafactor's state with it) restored
into another (one process, ``tp=2``, ``fsdp=2``), on the CPU over gloo.

Each rank writes its block of every tensor with its offset on every dim
(``parallel/sharding.Block``); restore memory-maps the ranks' files and
copies only the block this rank holds in the new layout. Held bit for bit:
the whole step restored by one process equals the saving world's gathered
parameters; every restoring rank's parameters and adafactor statistics
equal their block of that whole; and the elements a rank copies out of the
files are exactly its blocks' (not the whole tensors').
"""

import numpy as np
import pytest

import tests.jaxenv  # noqa: F401

from pytorch_operator_tpu_torch.checkpoint import CheckpointManager, integrity
from tests import torch_worlds

KW = dict(config="tiny", batch_size=8, seq_len=32, steps=2, warmup=1, lr=1e-2,
          optimizer="adafactor", checkpoint_every=1000)
SAVES = {"tp": "tp=2", "fsdp": "fsdp=2", "fsdp_tp": "fsdp=2,tp=2"}
# (saved by, restored into): tp=2 → one process is the whole restore.
CROSS = [("fsdp", "tp=2"), ("fsdp_tp", "fsdp=2"), ("tp", "fsdp=2")]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_ckpt")
    runs = {}
    two = torch_worlds.run_world("train", [
        dict(KW, mesh_spec=SAVES[k], env={"TPUJOB_CHECKPOINT_DIR": str(d / k)}) for k in ("tp", "fsdp")
    ])
    four = torch_worlds.run_world("train", [
        dict(KW, mesh_spec=SAVES["fsdp_tp"], env={"TPUJOB_CHECKPOINT_DIR": str(d / "fsdp_tp")})
    ], n=4, timeout=300)
    runs["tp"], runs["fsdp"], runs["fsdp_tp"] = two[0][0], two[0][1], four[0][0]
    wholes = {}
    for k in SAVES:
        assert integrity.list_steps(d / k) == [3] and integrity.verify_step(d / k, 3)
        wholes[k] = CheckpointManager(d / k, create=False).restore({"params": None, "opt_state": None}, step=3)
    restored = {}
    for src, spec in CROSS:
        restored[(src, spec)] = torch_worlds.run_world("restore_layout", str(d / src), 3, spec, "adafactor")
    return d, runs, wholes, restored


@pytest.mark.parametrize("src", sorted(SAVES))
def test_one_process_restore_equals_the_gathered_parameters(src, saved):
    _, runs, wholes, _ = saved
    got = wholes[src]["params"]
    assert got.keys() == runs[src]["params"].keys()
    for name, p in runs[src]["params"].items():
        np.testing.assert_array_equal(got[name].numpy(), p, err_msg=name)
    assert wholes[src]["opt_state"]["count"] == 3


def _check_blocks(blocks: dict, whole: dict, what: str) -> int:
    """Each writer's block equals its box of the whole; the elements held."""
    n = 0
    for name, b in blocks.items():
        if isinstance(b, dict) and "offsets" not in b:
            n += _check_blocks(b, whole[name], f"{what}/{name}")
            continue
        if not isinstance(b, dict):
            continue
        box = tuple(slice(o, o + s) for o, s in zip(b["offsets"], b["data"].shape))
        want = whole[name].float().numpy()[box]
        np.testing.assert_array_equal(b["data"], want, err_msg=f"{what}/{name}")
        n += b["data"].size
    return n


@pytest.mark.parametrize("src,spec", CROSS, ids=[f"{s}-to-{m}" for s, m in CROSS])
def test_restore_across_layouts_is_bit_equal_and_reads_only_the_block(src, spec, saved):
    _, _, wholes, restored = saved
    whole = wholes[src]
    ranks = restored[(src, spec)]
    for r in ranks:
        held = _check_blocks(r["params"], whole["params"], "params")
        held += _check_blocks(r["opt"]["adafactor"], whole["opt_state"]["adafactor"], "adafactor")
        assert r["opt"]["count"] == 3
        # Read: exactly the elements of its blocks (placeholders included).
        assert r["read"] == held, (r["read"], held)
    n_whole = sum(t.numel() for t in whole["params"].values()) + sum(
        t.numel() for st in whole["opt_state"]["adafactor"].values() for t in st.values())
    assert all(r["read"] < 0.75 * n_whole for r in ranks), ([r["read"] for r in ranks], n_whole)
