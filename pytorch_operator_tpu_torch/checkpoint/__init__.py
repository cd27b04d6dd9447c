"""Checkpoint/resume for the port's workloads (``torch.save``-backed) — the
counterpart of ``pytorch_operator_tpu/checkpoint/``: the step-keyed manager
and the checksum sidecars the supervisor's reconciler reads."""

from .manager import CheckpointManager, job_checkpoint_dir

__all__ = ["CheckpointManager", "job_checkpoint_dir"]
