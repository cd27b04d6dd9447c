"""The port stands alone and never falls back to the CPU on its own.

- No module of pytorch_operator_tpu_torch/ (nor chip_smoke.py) imports jax,
  flax, optax, orbax or the JAX package — by AST scan, and by importing every
  port module in a subprocess where those imports are poisoned; the int8
  module ``ops/quantize.py`` runs there too.
- Entry points resolve to CUDA unless the caller asks for the CPU; without a
  GPU they raise. The kernel wrapper raises for tensors it cannot serve, and
  the build raises when nvcc is missing.
- The port's status channel writes the records the supervisor folds.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "pytorch_operator_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pytorch_operator_tpu"}


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_forbidden_imports_by_ast():
    offenders = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert len(_port_files()) > 10
    assert not offenders, offenders


def test_every_module_imports_with_jax_poisoned():
    code = f"""
import importlib, pkgutil, sys
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None
import pytorch_operator_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
print(len(mods))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 12


def test_quantize_module_stands_alone():
    """``ops/quantize.py`` is among the scanned files, and imports, with the
    model, converter and workloads that use it, where jax and the JAX
    package are poisoned."""
    assert PKG / "ops" / "quantize.py" in _port_files()
    code = f"""
import sys
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None
import torch
from pytorch_operator_tpu_torch.ops import quantize
from pytorch_operator_tpu_torch.models import convert, llama
from pytorch_operator_tpu_torch.workloads import generate, serve
qt = quantize.quantize(torch.ones(2, 3), -1)
print(qt.q.dtype, convert.is_quantized_tree({{"lm_head": {{"kernel": qt}}}}))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["torch.int8", "True"]


def test_slice7_modules_stand_alone(tmp_path):
    """The data layer, the checkpoint manager, remat and quality_eval are
    among the scanned files, and import and run (a pack, a save and a
    params-only restore) where jax and the JAX package are poisoned."""
    for rel in ("data/array_file.py", "data/native_loader.py", "data/pack.py",
                "checkpoint/integrity.py", "checkpoint/manager.py", "models/common.py",
                "workloads/quality_eval.py"):
        assert PKG / rel in _port_files()
    code = f"""
import sys
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None
import numpy as np, torch
from pytorch_operator_tpu_torch.checkpoint import CheckpointManager
from pytorch_operator_tpu_torch.data import pack_arrays, read_meta
from pytorch_operator_tpu_torch.models import common, llama
from pytorch_operator_tpu_torch.workloads import quality_eval
pack_arrays({str(tmp_path / "t.bin")!r}, {{"tokens": np.zeros((3, 4), np.int32)}})
mgr = CheckpointManager({str(tmp_path / "ck")!r})
mgr.save(5, {{"params": {{"w": torch.ones(2)}}}})
print(read_meta({str(tmp_path / "t.bin")!r}).n_records, mgr.restore_subtree("params")[0],
      common.remat_policy(llama.llama_tiny(remat=True)))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["3", "5", "None"]


def test_slice8_modules_stand_alone(tmp_path):
    """The async writer, the device feed and its autotuner, the profile
    report and adafactor are among the scanned files, and import and run (an
    async save and restore, a prefetched batch, an adafactor step, a
    profile's report) where jax and the JAX package are poisoned."""
    for rel in ("checkpoint/async_writer.py", "data/device_prefetch.py", "data/feed_autotune.py",
                "profiling.py"):
        assert PKG / rel in _port_files()
    code = f"""
import sys
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None
import numpy as np, torch
from pytorch_operator_tpu_torch import profiling
from pytorch_operator_tpu_torch.checkpoint import CheckpointManager
from pytorch_operator_tpu_torch.data.device_prefetch import DevicePrefetcher
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.workloads import trainer
mgr = CheckpointManager({str(tmp_path / "ck")!r})
mgr.save(5, {{"params": {{"w": torch.ones(2)}}}}, block=False)
step = mgr.restore_or_none({{"params": {{}}}})[0]
pf = DevicePrefetcher(lambda: np.arange(3), device="cpu")
got = pf.get().tolist()
pf.close()
model = llama.Llama(llama.llama_tiny())
opt = trainer.make_optimizer(model, 1e-2, optimizer="adafactor")
trainer.make_lm_train_step(model, opt)(torch.zeros(2, 8, dtype=torch.long))
with trainer.maybe_profile({str(tmp_path / "prof")!r}, log=lambda m: None):
    torch.ones(4) @ torch.ones(4)
report = profiling.device_report({str(tmp_path / "prof")!r}, "cpu")
print(step, got, opt.count, report["device"])
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["5", "[0,", "1,", "2]", "1", "cpu"]


def test_slice9_moe_stands_alone():
    """``parallel/`` (the MoE layer) is among the scanned files, and the MoE
    Llama imports and trains a step, and its layer runs both dispatches,
    where jax and the JAX package are poisoned."""
    for rel in ("parallel/__init__.py", "parallel/moe.py"):
        assert PKG / rel in _port_files()
    code = f"""
import sys
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None
import torch
from pytorch_operator_tpu_torch import parallel
from pytorch_operator_tpu_torch.models import llama
from pytorch_operator_tpu_torch.workloads import trainer
cfg = llama.llama_tiny(n_experts=4, moe_aux_weight=1e-2, moe_dispatch="sparse")
model = llama.Llama(cfg).init_weights(torch.Generator().manual_seed(0))
aux = []
step = trainer.make_lm_train_step(model, trainer.make_optimizer(model, 1e-2, optimizer="adafactor"),
                                  on_aux=aux.append)
step(torch.zeros(2, 8, dtype=torch.long))
p = {{k: getattr(model.layers[0].moe_mlp, k) for k in ("gate", "w_in", "w_out")}}
x = torch.randn(6, cfg.d_model)
print(parallel.moe_mlp_sparse(p, x, capacity_factor=2.0).shape[0],
      parallel.moe_mlp_reference(p, x).shape[0], len(aux))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["6", "6", "1"]


def test_slice10_multi_process_modules_stand_alone(tmp_path):
    """The multi-process modules (the rendezvous, ``parallel/{mesh,
    collectives,data,sharding,logical}.py``, ``checkpoint/multihost.py``,
    ``workloads/smoke_dist.py``) are among the scanned files, and two ranks
    where jax and the JAX package are poisoned join a world, pass the
    canary's checks, and train and save a tiny fsdp=2 run."""
    for rel in ("parallel/mesh.py", "parallel/collectives.py", "parallel/data.py",
                "parallel/sharding.py", "parallel/logical.py", "checkpoint/multihost.py",
                "workloads/smoke_dist.py", "runtime/rendezvous.py"):
        assert PKG / rel in _port_files()
    code = f"""
import os, sys
for name in {sorted(FORBIDDEN)!r}:
    sys.modules[name] = None
import torch
from pytorch_operator_tpu_torch.runtime import rendezvous
from pytorch_operator_tpu_torch.workloads import llama_train, smoke_dist
world = rendezvous.initialize_from_env()
assert smoke_dist.checks(world, torch.device("cpu"), None) == []
r = llama_train.run(config="tiny", device="cpu", mesh_spec="fsdp=2", batch_size=4, seq_len=8,
                    steps=1, warmup=1, checkpoint_every=2, log=lambda m: None)
print(world.backend, r["world"], sorted(os.listdir(os.path.join(os.environ["TPUJOB_CHECKPOINT_DIR"], "2"))))
rendezvous.finalize(world)
"""
    from tests.torch_worlds import free_port, world_env

    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, **world_env(rank, 2, port,
                                                         TPUJOB_CHECKPOINT_DIR=tmp_path / "ck")),
        )
        for rank in range(2)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0].split()[-7:] == ["gloo", "2", "['meta.json',", "'opt_state.r0.pt',",
                                       "'opt_state.r1.pt',", "'params.r0.pt',", "'params.r1.pt']"]


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the no-fallback path is not reachable")


def test_generate_main_refuses_cpu_fallback(monkeypatch):
    """Without --device cpu and without TPUJOB_PLATFORM=cpu, the entry point
    targets CUDA and raises on a GPU-less box instead of running on the CPU."""
    _no_gpu()
    from pytorch_operator_tpu_torch.workloads import generate

    monkeypatch.delenv("TPUJOB_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--config", "tiny", "--max-new-tokens", "2", "--prompt-len", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--config", "tiny", "--device", "cuda"])


def test_int8_entry_points_need_a_gpu(monkeypatch, tmp_path):
    """The int8 stack falls back no more than the bf16 one: without a CPU
    request its entry points raise on a GPU-less box."""
    _no_gpu()
    from pytorch_operator_tpu_torch.workloads import generate, serve

    monkeypatch.delenv("TPUJOB_PLATFORM", raising=False)
    int8 = ["--quantize", "int8", "--kv-quantize", "int8"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--config", "tiny", "--compare-unquantized", *int8])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--spool", str(tmp_path), "--init-host", *int8])


def test_journey_entry_points_need_a_gpu(monkeypatch, tmp_path):
    """quality_eval, and generate/serve with --restore, fall back no more
    than the rest: without a CPU request they raise on a GPU-less box."""
    _no_gpu()
    from pytorch_operator_tpu_torch.workloads import generate, quality_eval, serve

    monkeypatch.delenv("TPUJOB_PLATFORM", raising=False)
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_eval.main(["--restore", ck, "--eval-file", str(tmp_path / "e.bin")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--config", "tiny", "--restore", ck])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--spool", str(tmp_path), "--restore", ck])


@pytest.mark.parametrize(
    "requested,env,expected",
    [("cpu", None, "cpu"), (None, "cpu", "cpu"), ("cpu", "tpu", "cpu")],
)
def test_device_resolution_honours_cpu_requests(monkeypatch, requested, env, expected):
    from pytorch_operator_tpu_torch.runtime.device import resolve_device

    if env is None:
        monkeypatch.delenv("TPUJOB_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("TPUJOB_PLATFORM", env)
    assert resolve_device(requested).type == expected


def test_cuda_requests_raise_without_gpu(monkeypatch):
    _no_gpu()
    from pytorch_operator_tpu_torch.runtime.device import resolve_device

    monkeypatch.setenv("TPUJOB_PLATFORM", "tpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_kernel_wrapper_never_falls_back():
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper raises for a device the kernel does not serve, and the kernel
    path raises for a dtype it does not take."""
    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    meta = [torch.empty(1, 64, 2, 64, device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="kernel takes CUDA"):
        fa.flash_attention(*meta)
    half = [torch.zeros(1, 64, 2, 64, dtype=torch.float16) for _ in range(3)]
    before = fa.launch_count
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._launch(*half, causal=True, kv_len=64, scale=0.125)
    assert fa.launch_count == before


def test_backward_wrapper_never_falls_back(monkeypatch):
    """The backward kernels' wrapper raises when a launch fails (here a
    stand-in library whose entry points return a CUDA error), and for a
    dtype the kernels do not take; it never computes the plain version, and
    the launch counts do not move."""
    import contextlib
    import types

    from pytorch_operator_tpu_torch.ops import flash_attention as fa

    calls = []

    def failing(name, rc):
        def entry(*args):
            calls.append(name)
            return rc
        return entry

    lib = types.SimpleNamespace(
        flash_bwd_dq=failing("dq", 700), flash_bwd_dkv=failing("dkv", 0)
    )
    monkeypatch.setitem(fa._libs, "flash_bwd", lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=0)
    )
    monkeypatch.setattr(
        fa, "flash_attention_backward_reference",
        lambda *a, **k: pytest.fail("the plain version ran for a kernel request"),
    )
    q, k, v, o, do = (torch.zeros(1, 64, 2, 64) for _ in range(5))
    lse = torch.zeros(2, 64)
    before = (fa.dq_launch_count, fa.dkv_launch_count)
    with pytest.raises(RuntimeError, match="flash_bwd_dq kernel launch failed: CUDA error 700"):
        fa._launch_bwd(q, k, v, o, lse, do, causal=True, kv_len=64, scale=0.125)
    assert calls == ["dq"] and (fa.dq_launch_count, fa.dkv_launch_count) == before
    half = [x.half() for x in (q, k, v, o, do)]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._launch_bwd(*half[:4], lse, half[4], causal=True, kv_len=64, scale=0.125)
    assert calls == ["dq"]


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from pytorch_operator_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_fwd"])


def test_status_channel_and_world(monkeypatch, tmp_path):
    from pytorch_operator_tpu_torch.runtime import rendezvous

    monkeypatch.setenv("TPUJOB_STATUS_DIR", str(tmp_path))
    monkeypatch.setenv("TPUJOB_REPLICA_TYPE", "Worker")
    monkeypatch.setenv("TPUJOB_REPLICA_INDEX", "3")
    monkeypatch.setenv("TPUJOB_NUM_PROCESSES", "1")
    assert rendezvous.initialize_from_env().replica_index == 3
    rendezvous.report_first_step(0)
    rendezvous.report_metrics(7, decode_tokens_per_sec=12.5)
    recs = [json.loads(line) for line in (tmp_path / "worker-3.jsonl").read_text().splitlines()]
    assert [r["event"] for r in recs] == ["first_step", "metrics"]
    assert recs[1]["step"] == 7 and recs[1]["decode_tokens_per_sec"] == 12.5
    # A world of two whose peer never comes raises; it never runs on as a
    # world of one.
    from tests.torch_worlds import free_port

    monkeypatch.setenv("TPUJOB_NUM_PROCESSES", "2")
    monkeypatch.setenv("TPUJOB_COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    with pytest.raises(TimeoutError, match="rendezvous with coordinator"):
        rendezvous.initialize_from_env(timeout_s=1, retry_interval_s=0.2)


@pytest.mark.parametrize(
    "argv",
    [["--optimizer", "adafactor"], ["--prefetch", "2", "--feed-autotune"], ["--async-checkpoint"],
     ["--profile-dir", "prof"], ["--preempt-at", "5"]],
    ids=["adafactor", "prefetch", "async-checkpoint", "profile-dir", "preempt-at"],
)
def test_slice8_entry_points_need_a_gpu(monkeypatch, tmp_path, argv):
    """llama_train with the slice's flags falls back no more than without
    them: without a CPU request it raises on a GPU-less box."""
    _no_gpu()
    from pytorch_operator_tpu_torch.workloads import llama_train

    monkeypatch.delenv("TPUJOB_PLATFORM", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama_train.main(["--steps", "1", "--seq-len", "8", *argv])


def test_device_feed_never_falls_back_to_the_cpu():
    """The feed's default put targets the card: without one, the failure
    reaches the consumer's get() instead of a CPU batch."""
    _no_gpu()
    import numpy as np

    from pytorch_operator_tpu_torch.data.device_prefetch import DevicePrefetcher

    pf = DevicePrefetcher(lambda: np.zeros(2))
    try:
        with pytest.raises((RuntimeError, AssertionError)):
            pf.get()
    finally:
        pf.close()
