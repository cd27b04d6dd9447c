"""The port's data-plane bench (pytorch_operator_tpu_torch/workloads/dataplane_bench.py)
on the CPU: its structural invariants, and its artifact's keys against the
JAX package's.

- every cell ends sidecar-verified (``latest_verified_step`` equals the
  newest saved step);
- prefetched cells make zero puts on the step thread (inline cells one a
  step);
- staged cells make zero step-thread fetches beyond the bench's own loss
  fences; a planted step-thread read in the staged submit is counted (the
  meter can fail), and the meter's rule on (faked) card tensors counts the
  eager snapshot's reads and any blocking copy to the host, and no
  ``non_blocking`` copy;
- the autotuned feed's depth stays within ``depth_max``;
- with tracing off the cells emit no span record.

Wall-clock orders (staged < async < blocking stalls) are checked on the card
by ``chip_smoke.py`` phase 17(c), not here: on the CPU there is no copy
engine, and the JAX package's own ordering test already flakes under
parallel workers.
"""

import json
import os
import threading

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import _get_current_dispatch_mode

from pytorch_operator_tpu_torch.checkpoint import async_writer, manager
from pytorch_operator_tpu_torch.obs import trace as obs_trace
from pytorch_operator_tpu_torch.workloads import dataplane_bench

SMALL = dict(steps=18, checkpoint_every=6, dim=128, batch=128, feed_steps=36)
# The fused Adam's state tensors: two parameters, two moments each, two step
# counts.
STATE_TENSORS = 8


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    os.environ.pop(obs_trace.ENV_VAR, None)
    obs_trace.reset_tracer()
    return dataplane_bench.run(**SMALL, work_dir=str(tmp_path_factory.mktemp("dataplane")),
                               device="cpu", log=lambda *_: None)


def _cell(result, ckpt, feed):
    return next(c for c in result["cells"] if c["ckpt"] == ckpt and c["feed"] == feed)


def test_every_cell_ends_sidecar_verified(result):
    for c in result["cells"]:
        assert c["all_saves_verified"], c
        assert c["last_verified_step"] == c["last_saved_step"] == c["steps"], c
        assert c["saves"] == SMALL["steps"] // SMALL["checkpoint_every"]
    assert result["comparisons"]["async_saves_verified"] is True


def test_prefetched_cells_make_no_step_thread_puts(result):
    for ckpt in ("blocking", "async", "staged"):
        assert _cell(result, ckpt, "prefetched")["step_thread_device_puts"] == 0
        inline = _cell(result, ckpt, "inline")
        assert inline["step_thread_device_puts"] == inline["steps"]
    assert result["comparisons"]["prefetched_step_thread_puts"] == 0


def test_staged_cells_fetch_nothing_beyond_the_fences(result):
    """Every cell reads back its loss fences and nothing more on the CPU: the
    staged submit's copies are issued ``non_blocking`` on the card, and on
    the CPU the eager snapshot's copies are host copies, not reads of a
    device (the card shows them, one a state tensor a save, in
    ``chip_smoke.py`` phase 17(c); the fake-card case below shows the rule)."""
    for feed in ("inline", "prefetched"):
        for ckpt in ("staged", "async"):
            c = _cell(result, ckpt, feed)
            assert c["step_thread_gets_beyond_budget"] == 0, c
            assert c["step_thread_device_gets"] == c["device_get_budget"] == c["saves"] + 1, c
    assert result["comparisons"]["staged_step_thread_gets_beyond_budget"] == 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_a_planted_step_thread_fetch_in_a_staged_cell_is_counted(tmp_path, monkeypatch):
    """The staged submit regressed to reading every state tensor back on the
    step thread (a finiteness check before staging): the meter, which sees
    every ``.item()`` at the dispatcher, counts one read a state tensor a
    save although no snapshot function changed."""
    real_stage = manager.stage_mutable_leaves

    def checking_stage(tree):
        assert all(bool(torch.isfinite(x).all()) for x in _leaves(tree))
        return real_stage(tree)

    monkeypatch.setattr(manager, "stage_mutable_leaves", checking_stage)
    c = dataplane_bench.bench_cell(
        ckpt_mode="staged", feed_mode="inline", steps=4, checkpoint_every=2, dim=32, batch=16,
        prefetch_depth=2, work_dir=str(tmp_path), device="cpu", log=lambda *_: None,
    )
    assert c["step_thread_gets_beyond_budget"] == STATE_TENSORS * c["saves"] > 0, c
    assert c["all_saves_verified"]
    # The meter is gone once the cell ends.
    assert _get_current_dispatch_mode() is None


def test_the_meter_counts_blocking_reads_of_a_card_tensor():
    """The meter's rule on CUDA tensors, faked on the CPU: the eager snapshot
    reads each card tensor back; a blocking ``.cpu()`` or ``copy_`` into a
    pinned buffer is a read wherever it is issued; the staged submit's
    ``non_blocking`` copy and a host copy are not; nor is anything another
    thread dispatches (a put to the card cannot be faked on a build without
    CUDA; puts are counted at the feed's ``put``)."""
    cuda = torch.device("cuda")
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = {"params": {"w": torch.empty(4, 8, device=cuda)},
                 "opt": {"m": torch.empty(4, 8, device=cuda), "step": torch.empty((), device=cuda)}}
        x, buf = state["params"]["w"], torch.empty(4, 8, pin_memory=True)
        counts = {}
        cases = {
            "eager snapshot": lambda: async_writer.snapshot_to_host(state),
            "blocking .cpu()": lambda: x.cpu(),
            "blocking copy_": lambda: buf.copy_(x),
            "non_blocking copy_": lambda: buf.copy_(x, non_blocking=True),
            "non_blocking .to()": lambda: x.to("cpu", non_blocking=True),
            "host copy": lambda: buf.clone(),
            "another thread's .cpu()": lambda: _in_thread(x.cpu),
        }
        for name, op in cases.items():
            with dataplane_bench._TransferMeter(threading.get_ident(), cuda) as meter:
                op()
            counts[name] = meter.step_thread_gets
    assert counts == {"eager snapshot": 3, "blocking .cpu()": 1, "blocking copy_": 1,
                      "non_blocking copy_": 0, "non_blocking .to()": 0, "host copy": 0,
                      "another thread's .cpu()": 0}


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join()


def test_autotuned_depth_stays_within_its_budget(result):
    fc = {c["feed_cell"]: c for c in result["feed_cells"]}
    assert fc["autotuned"]["depth_peak"] <= fc["autotuned"]["depth_max"] == 8
    assert fc["static"]["depth_peak"] == fc["static"]["depth_initial"] == 2
    assert result["comparisons"]["autotuned_depth_within_max"]


def test_tracing_off_emits_no_spans(result):
    for c in result["cells"]:
        assert c["trace_enabled"] is False and c["span_records"] == 0, c
    assert result["comparisons"]["trace_disabled_zero_spans"] is True


def test_artifact_keys_equal_jax_and_go_only_to_out(result, tmp_path, monkeypatch, capsys):
    import tests.jaxenv  # noqa: F401
    from pytorch_operator_tpu.workloads import dataplane_bench as jax_bench

    tiny = dict(steps=2, checkpoint_every=2, dim=8, batch=8, feed_steps=4, feed_depth_max=4,
                burst_every=4)
    want = jax_bench.run(**tiny, work_dir=str(tmp_path), log=lambda *_: None)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "dataplane.json"
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in tiny.items()]
    assert dataplane_bench.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert set(got) == set(want) == set(result)
    assert set(got["comparisons"]) == set(want["comparisons"])
    for key in ("cells", "feed_cells"):
        assert [sorted(c) for c in got[key]] == [sorted(c) for c in want[key]]
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {"comparisons": got["comparisons"]}
    assert sorted(p.name for p in tmp_path.iterdir() if p.suffix == ".json") == ["dataplane.json"]
