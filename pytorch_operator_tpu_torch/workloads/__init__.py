"""Runnable entry points of the port (``python -m pytorch_operator_tpu_torch.workloads.<name>``)."""
