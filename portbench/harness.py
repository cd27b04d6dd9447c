"""One run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``: the model's sizes as
they are run, with their source, what was cut and what was assumed) and a
traffic mix (``mixes/<traffic>.json``: for ``"kind": "train"``, the batch,
the sequence length, the remat policy and the token pool). Its limits are
``checks/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``'s ``read(run)``. Nothing here names a cell: a run
reports each end-to-end metric that its kind of run measures, and with
``trace`` each per-layer metric that ``moves`` one of those and whose reader
finds something to read.

A training run:

1. builds the port's training object from the seed: ``Llama`` with the flash
   kernels and the chunked loss, AdamW (``trainer.make_optimizer``) and
   ``trainer.make_lm_train_step``;
2. runs the checked steps on the first batches of the token pool (they warm
   up every shape of the window), reading after the first step the gradient
   norms from AdamW's first moment and after the last the parameters'
   change;
3. trains back to back over the pool for the window: whole steps, from the
   start of the first to a synchronize after the first that ends past
   ``seconds``, with no host read of a loss inside; reads the peak memory;
   with ``trace``, trains a second such window under ``torch.profiler``
   (the per-layer readers see the first, untraced, window's rate and the
   second's trace);
4. frees the program, runs the per-layer readers (traced runs), then the
   plain f32 reference over the checked steps, and compares
   (``check.py``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import torch

from . import check, reference, trace, weights

ROOT = Path(__file__).resolve().parents[1]
WINDOW = "portbench.window"
# Modules that no run may load, compared by the top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pytorch_operator_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=w["chips"],
        config=_read_json(root / conf["file"]),
        mix=_read_json(root / "portbench" / "mixes" / f"{w['traffic']}.json"),
        limits=_read_json(root / "portbench" / "checks" / f"{name}.json"),
        end_to_end=bench["end_to_end"],
        per_layer=bench["per_layer"],
        root=root,
    )


def load_reader(cell: Cell, metric: str) -> Callable:
    """``read`` of ``portbench/metrics/<metric>.py`` under the cell's root."""
    path = cell.root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def kernels_built() -> List[str]:
    """The port's CUDA kernels that this process compiled (a checkout's
    first run builds them; later runs load them from its cache)."""
    from pytorch_operator_tpu_torch.ops import _build

    return sorted(_build.build_logs)


class PortTrainer:
    """The system under test: the port's Llama (flash attention, chunked
    loss) with AdamW and its train step, weights from the seed."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device, log=lambda m: None):
        from pytorch_operator_tpu_torch.models.llama import Llama, LlamaConfig
        from pytorch_operator_tpu_torch.workloads import trainer

        log("the port imported")

        lcfg = LlamaConfig(
            vocab_size=cfg["vocab_size"],
            d_model=cfg["hidden_size"],
            n_layers=cfg["num_hidden_layers"],
            n_heads=cfg["num_attention_heads"],
            n_kv_heads=cfg["num_key_value_heads"],
            head_dim=cfg["head_dim"],
            d_ff=cfg["intermediate_size"],
            rope_theta=cfg["rope_theta"],
            rms_eps=cfg["rms_norm_eps"],
            dtype=getattr(torch, cfg["torch_dtype"]),
            param_dtype=getattr(torch, cfg["assumed"]["param_dtype"]),
            remat=mix["remat"] is not None,
            remat_policy=mix["remat"] or "full",
            attn_impl="flash",
            xent_impl="chunked",
        )
        self.model = Llama(lcfg, device="meta").to_empty(device=device)
        log("the model allocated")
        self.named = dict(self.model.named_parameters())
        weights.load_into(self.named, cfg, seed)
        log("the weights drawn")
        opt = cfg["assumed"]["optimizer"]
        self.optimizer = trainer.make_optimizer(
            self.model, opt["lr"], weight_decay=opt["weight_decay"], optimizer="adamw"
        )
        self.step = trainer.make_lm_train_step(self.model, self.optimizer)

    @torch.no_grad()
    def first_grad_norms(self, beta1: float) -> dict:
        """Per parameter, the first gradient's norm as AdamW got it: ``‖m₁‖ /
        (1 − β₁)`` (device scalars)."""
        state = self.optimizer.adamw.state
        out = {}
        for n, p in self.named.items():
            m = state.get(p, {}).get("exp_avg")
            # No first moment: the optimizer took no gradient of it.
            out[n] = p.new_zeros(()) if m is None else torch.linalg.vector_norm(m) / (1 - beta1)
        return out


@dataclass
class Checked:
    """The program's readings over the checked steps, still on the card."""

    losses: list
    grad_norms: dict
    change_norms: dict

    def readings(self) -> reference.Readings:
        return reference.Readings(
            losses=[float(x) for x in torch.stack(self.losses).tolist()],
            grad_norms={n: float(v) for n, v in self.grad_norms.items()},
            change_norms={n: float(v) for n, v in self.change_norms.items()},
        )


def check_steps(prog: "PortTrainer", pool: torch.Tensor, k: int, cfg: dict, seed: int,
                log=lambda m: None) -> Checked:
    """The first ``k`` steps on the pool's first batches, read as the
    comparison needs them; they also warm up every shape of the window."""
    if pool.shape[0] <= k:
        raise ValueError(f"the mix's pool of {pool.shape[0]} batches must exceed the {k} checked steps")
    losses, grads = [], None
    for i in range(k):
        losses.append(prog.step(pool[i]))
        if i == 0:
            grads = prog.first_grad_norms(cfg["assumed"]["optimizer"]["betas"][0])
        log(f"step {i + 1}")
    change = weights.change_norms(prog.named, cfg, seed)
    log("change norms")
    return Checked(losses, grads, change)


@dataclass
class Window:
    steps: int
    seconds: float
    losses: list = field(repr=False, default_factory=list)


def train_window(step, pool: torch.Tensor, first: int, seconds: float, device: torch.device,
                 span=contextlib.nullcontext) -> Window:
    """Whole steps over ``pool`` from batch ``first`` on, back to back, until
    a step ends past ``seconds``; then a synchronize. The host runs at most
    one step ahead of the card (it waits on the previous step's event)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    losses, prev, n = [], None, 0
    t0 = time.perf_counter()
    with span():
        while True:
            losses.append(step(pool[(first + n) % pool.shape[0]]))
            n += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                if prev is not None:
                    prev.synchronize()
                prev = ev
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
    return Window(steps=n, seconds=t1 - t0, losses=losses)


@dataclass
class RunView:
    """What a per-layer reader sees: the cell, the device, the measured
    (untraced) window and, in a traced run, the trace of the traced window
    that followed it."""

    cell: Cell
    device: torch.device
    window: Window
    trace: Optional[trace.TraceView]

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix


@contextlib.contextmanager
def _profiled(device: torch.device, out: list):
    """Profile the block; append the read :class:`trace.TraceView` (or
    None) to ``out``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(path)
        out.append(trace.read(path, WINDOW))
    finally:
        os.unlink(path)


def free_memory(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_train(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
              t_process: float, log=None) -> dict:
    """One run of a training cell; returns the result (see ``run.py``)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cfg, mix = cell.config, cell.mix
    k = cell.limits["steps"]
    cuda = device.type == "cuda"

    since = lambda: time.perf_counter() - t_process  # noqa: E731
    phase = lambda m: log(f"set-up: {m} at {since():.2f} s")  # noqa: E731
    phase("the harness imported")
    if cuda:
        torch.cuda.init()
        phase("CUDA initialised")
    prog = PortTrainer(cfg, mix, seed, device, log=phase)
    pool = weights.tokens(cfg, mix, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    phase("the optimizer and the token pool made")
    checked = check_steps(prog, pool, k, cfg, seed, log=phase)
    built = kernels_built()
    if built:
        phase(f"built {', '.join(built)} in this run (a checkout's first)")

    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_process
    win = train_window(prog.step, pool, k, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    log(f"window: {win.steps} steps in {win.seconds:.4f} s after {setup_s:.4f} s of set-up"
        + (f"; peak {peak / 2**30:.3f} GiB allocated, "
           f"{torch.cuda.max_memory_reserved(device) / 2**30:.3f} GiB reserved" if cuda else ""))
    windows = [win]
    traces: list = []
    if traced:
        span = (lambda: torch.profiler.record_function(WINDOW))  # noqa: E731
        with _profiled(device, traces):
            windows.append(train_window(prog.step, pool, k + win.steps, seconds, device, span=span))
        log(f"traced window: {windows[1].steps} steps in {windows[1].seconds:.4f} s")

    window_losses = torch.stack([x for w in windows for x in w.losses]).float()
    failed = int((~torch.isfinite(window_losses)).sum())
    prog_readings = checked.readings()
    for w in windows:
        w.losses = []
    del prog, checked
    free_memory(device)

    metrics: dict = {}
    values = {
        "train_tokens_per_s": win.steps * mix["batch"] * mix["seq_len"] / win.seconds,
        "peak_mem_gib": None if peak is None else peak / 2**30,
        "setup_s": setup_s,
    }
    view = RunView(cell, device, win, traces[0] if traces else None)
    if traced:
        for m in cell.per_layer:
            if m["moves"] not in values:
                continue
            t_read = time.perf_counter()
            v = load_reader(cell, m["name"])(view)
            log(f"{m['name']}: {v!r} in {time.perf_counter() - t_read:.2f} s")
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        free_memory(device)
    else:
        for m in cell.end_to_end:
            v = values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    t_ref = time.perf_counter()
    ref = reference.train_readings(cfg, [pool[i] for i in range(k)], seed)
    log(f"reference: {k} steps in {time.perf_counter() - t_ref:.2f} s"
        + (f", peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB" if cuda else ""))
    judged = check.judge(check.numbers(prog_readings, ref), cell.limits["limits"])
    log("losses: program " + " ".join(f"{x:.6f}" for x in prog_readings.losses)
        + " | reference " + " ".join(f"{x:.6f}" for x in ref.losses)
        + f"; {len(ref.grad_norms) - len(check.moving(ref))} of {len(ref.grad_norms)} parameters"
        " too still for change_gap")

    result = {
        "correct": all(j["ok"] for j in judged.values()) and failed == 0,
        "attempted": sum(w.steps for w in windows),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": cell.chips,
            "memory_peak_bytes": peak,
        },
    }
    tv = view.trace
    if tv is not None:
        result["device"]["busy_s"] = tv.busy_s
        result["device"]["window_s"] = tv.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in tv.device_ops],
            "idle_gaps": [[n, s] for n, s in tv.idle_gaps],
        }
    result["kernels_built"] = built
    result["checks"] = {
        n: {"value": j["value"] if math.isfinite(j["value"]) else None, "limit": j["limit"]}
        for n, j in judged.items()
    }
    return result


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
             t_process: float, log=None) -> dict:
    """One run of ``cell``; training is the one kind of mix."""
    if cell.mix.get("kind") != "train":
        raise ValueError(f"mix kind {cell.mix.get('kind')!r} is not 'train'")
    return run_train(cell, seed, seconds, traced, device, t_process, log)
