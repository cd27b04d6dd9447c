"""Device selection — the counterpart of ``pytorch_operator_tpu/runtime/backend.py``.

The rule every entry point of the port follows: run on ``cuda`` unless the
caller asks for the CPU, either explicitly (``device="cpu"``,
``--device cpu``) or through ``TPUJOB_PLATFORM=cpu`` — what the supervisor
injects for ``cpu_devices`` jobs and what the test suite sets. With no GPU
and no such request, resolution raises: a measurement or a job that silently
ran on the host would report host numbers under the device's name. In a
world of several processes each rank takes ``cuda:(rank % device count)``
(:func:`rank_device`).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """Return the device an entry point runs on.

    ``device`` wins when given. Otherwise ``TPUJOB_PLATFORM=cpu`` selects the
    CPU, and anything else selects ``cuda``. A CUDA device that this process
    cannot reach raises ``RuntimeError``.
    """
    if device is None:
        platform = os.environ.get("TPUJOB_PLATFORM", "")
        device = "cpu" if platform == "cpu" else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; pass "
            "device='cpu' (--device cpu) or set TPUJOB_PLATFORM=cpu to run "
            "on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


def rank_device(process_id: int, device: Union[str, torch.device, None] = None) -> torch.device:
    """The device of rank ``process_id`` in a multi-process world: the
    :func:`resolve_device` rule, and on CUDA the card
    ``cuda:(process_id % device_count)`` unless ``device`` names one. Ranks
    of one host with fewer cards than ranks share cards (the rendezvous then
    picks gloo: NCCL refuses two ranks on one GPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def device_name(dev: torch.device) -> str:
    """Human-readable name of ``dev`` for logs and result records."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def synchronize(dev: Optional[torch.device]) -> None:
    """Wait for queued work on ``dev`` (no-op on the CPU)."""
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
