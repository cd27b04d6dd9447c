"""The port's device feed (pytorch_operator_tpu_torch/data/device_prefetch.py,
data/feed_autotune.py) and the data-plane env defaults of its workloads, on
the CPU, against the JAX package's.

- ``DevicePrefetcher``: FIFO order across a worker pool, a ``close`` that
  wakes a blocked ``get``, a produce error delivered at its position and
  again after, ``set_depth`` clamped to ``[1, depth_max]``, autotune growing
  within ``depth_max``, the loader facade; the CPU ``put`` hands over tensors
  that own their bytes.
- ``FeedAutotuner``: the port's returns the JAX one's depths on the same
  stall sequences.
- ``llama_train.run`` inline and with ``prefetch=2`` (autotune, two workers),
  on the synthetic stream and on a data file: bit-equal losses.
- ``data_plane_env``: the five ``TPUJOB_*`` variables resolve as the JAX
  package's do, and explicit flags win.

No test asserts a wall-clock race: a stalling producer is a blocked one.
"""

import itertools
import threading

import numpy as np
import pytest
import torch

from pytorch_operator_tpu.data import feed_autotune as jax_autotune
from pytorch_operator_tpu.workloads import trainer as jax_trainer
from pytorch_operator_tpu_torch.data import feed_autotune
from pytorch_operator_tpu_torch.data.device_prefetch import (
    STALL_WINDOW,
    DevicePrefetcher,
    PrefetchedLoader,
    to_device,
)
from pytorch_operator_tpu_torch.workloads import llama_train, trainer


def test_fifo_order_with_worker_pool():
    c = itertools.count()
    pf = DevicePrefetcher(lambda: next(c), put=lambda x: x * 10, depth=4, workers=4)
    try:
        assert [pf.get() for _ in range(64)] == [i * 10 for i in range(64)]
    finally:
        pf.close()


def test_close_wakes_a_blocked_consumer():
    release = threading.Event()
    woke = threading.Event()
    outcome = {}
    pf = DevicePrefetcher(lambda: (release.wait(30), 1)[1], put=lambda x: x, depth=2)

    def consumer():
        try:
            pf.get()
            outcome["r"] = "got a batch"
        except RuntimeError as e:
            outcome["r"] = str(e)
        woke.set()

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    closer = threading.Thread(target=pf.close, daemon=True)
    closer.start()
    try:
        assert woke.wait(10), "consumer still blocked after close()"
        assert outcome["r"] == "prefetcher is closed"
        with pytest.raises(RuntimeError, match="closed"):
            pf.get()
    finally:
        release.set()
        closer.join(10)


def test_error_delivered_in_order_with_workers():
    c = itertools.count()

    def produce():
        v = next(c)
        if v == 5:
            raise ValueError("decode exploded")
        return v

    pf = DevicePrefetcher(produce, put=lambda x: x, depth=3, workers=3)
    try:
        assert [pf.get() for _ in range(5)] == [0, 1, 2, 3, 4]
        for _ in range(2):  # at its position, and again: never skipped
            with pytest.raises(ValueError, match="decode exploded"):
                pf.get()
    finally:
        pf.close()


def test_set_depth_clamps_to_bounds():
    pf = DevicePrefetcher(lambda: 1, put=lambda x: x, depth=2, depth_max=6)
    try:
        pf.set_depth(100)
        assert pf.depth == 6
        pf.set_depth(0)
        assert pf.depth == 1
        with pytest.raises(ValueError, match="depth"):
            DevicePrefetcher(lambda: 1, put=lambda x: x, depth=0)
    finally:
        pf.close()


def test_autotune_grows_depth_on_stall_within_max():
    """A producer that waits for each get (every get stalls) drives the
    depth up, never past ``depth_max``."""
    asked = threading.Semaphore(0)

    def produce():
        asked.acquire(timeout=10)
        return 1

    pf = DevicePrefetcher(produce, put=lambda x: x, depth=1, depth_max=4, autotune=True)
    try:
        for _ in range(STALL_WINDOW):
            threading.Timer(0.002, asked.release).start()
            pf.get()
        assert 1 < pf.depth <= 4 and pf.stats()["depth"] == pf.depth
    finally:
        for _ in range(16):
            asked.release()
        pf.close()


def test_prefetched_loader_keeps_order_across_the_pool():
    class FakeLoader:
        batches_per_epoch = 4

        def __init__(self):
            self._n = itertools.count()
            self.slot = np.zeros((2,), np.float32)

        def next_batch(self):
            n = next(self._n)
            self.slot[:] = n  # a borrowed slot, refilled at every call
            return 0, n, {"x": self.slot}

        def close(self):
            pass

    pl = PrefetchedLoader(FakeLoader(), 2, device="cpu", workers=3, depth_max=4, autotune=True)
    try:
        got = [pl.next_batch() for _ in range(12)]
        assert [g[1] for g in got] == list(range(12))
        assert [float(g[2]["x"][0]) for g in got] == [float(i) for i in range(12)]
        assert all(isinstance(g[2]["x"], torch.Tensor) for g in got)
    finally:
        pl.close()


def test_cpu_put_hands_over_owned_tensors():
    src = {"a": np.arange(4, dtype=np.int64), "b": torch.ones(2)}
    out = to_device(src, "cpu")
    src["a"][:] = -1
    src["b"].fill_(5.0)
    assert out["a"].tolist() == [0, 1, 2, 3] and out["b"].tolist() == [1.0, 1.0]


@pytest.mark.parametrize(
    "stalls",
    [
        [0.0] * 10 + [5.0] * 3 + [0.0] * 80,
        [2.0, 0.0] * 60,
        [0.0] * 4 + [1.0] * 20 + [0.0] * 200 + [3.0],
    ],
    ids=["burst", "alternating", "grow-then-shrink"],
)
def test_autotuner_returns_the_jax_depths(stalls):
    port = feed_autotune.FeedAutotuner(8, initial=2)
    ref = jax_autotune.FeedAutotuner(8, initial=2)
    assert [port.observe(s) for s in stalls] == [ref.observe(s) for s in stalls]
    assert (port.grows, port.shrinks) == (ref.grows, ref.shrinks)


def test_heartbeat_carries_the_recent_stall():
    class FakeFeed:
        def stats(self):
            return {"feed_stall_ms_avg": 0.01, "feed_stall_ms_recent": 42.0}

    records = []
    report = trainer.heartbeat_reporter(lambda step, **kw: records.append(kw), feed=FakeFeed())
    report(1, 0.5, 10.0)
    assert records[0]["feed_stall_ms"] == 42.0


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    from pytorch_operator_tpu_torch.data import pack_arrays

    path = tmp_path_factory.mktemp("feed") / "train.bin"
    toks = np.random.default_rng(0).integers(0, 256, (64, 33)).astype(np.int32)
    pack_arrays(path, {"tokens": toks})
    return str(path)


@pytest.mark.parametrize("source", ["synthetic", "data_file"])
def test_inline_and_prefetched_runs_train_on_the_same_batches(source, token_file):
    """The determinism contract: the feed changes where batches are made,
    never which arrive in what order — the losses are bit-equal."""
    kw = dict(config="tiny", batch_size=4, seq_len=32, steps=10, warmup=2, device="cpu",
              log=lambda m: None)
    if source == "data_file":
        kw["data_file"] = token_file
    inline = llama_train.run(**kw)
    fed = llama_train.run(prefetch=2, feed_autotune=True, prefetch_depth_max=8,
                          prefetch_workers=2, **kw)
    assert fed["losses"] == inline["losses"]
    assert fed["feed"]["gets"] == 12 and fed["feed"]["workers"] == 2
    assert 1 <= fed["feed"]["depth"] <= 8 and "feed" not in inline


ENV = {
    "TPUJOB_ASYNC_CHECKPOINT": ["1", "true", "0", ""],
    "TPUJOB_PREFETCH": ["3", "0", "-2", "x"],
    "TPUJOB_PREFETCH_DEPTH_MAX": ["8", "", "bad"],
    "TPUJOB_FEED_AUTOTUNE": ["TRUE", "no", ""],
    "TPUJOB_PREFETCH_WORKERS": ["4", "0", "nan"],
}


@pytest.mark.parametrize("var", sorted(ENV))
def test_data_plane_env_resolves_as_jax(var, monkeypatch):
    """Each variable, alone, resolves to the JAX package's value, through
    ``data_plane_env`` and through ``resolve_feed_tuning``; a flag given
    wins over it."""
    import argparse

    for other in ENV:
        monkeypatch.delenv(other, raising=False)
    for value in ENV[var]:
        monkeypatch.setenv(var, value)
        assert trainer.data_plane_env() == jax_trainer.data_plane_env(), (var, value)
        assert trainer.data_plane_env_defaults() == jax_trainer.data_plane_env_defaults()
        for argv in ([], ["--prefetch-depth-max", "5", "--no-feed-autotune",
                          "--prefetch-workers", "2"]):
            parsers = []
            for mod in (trainer, jax_trainer):
                p = argparse.ArgumentParser()
                mod.add_feed_tuning_args(p)
                parsers.append(mod.resolve_feed_tuning(p.parse_args(argv)))
            assert parsers[0] == parsers[1], (var, value, argv)
        if argv:
            assert parsers[0] == {"prefetch_depth_max": 5, "autotune": False, "prefetch_workers": 2}
