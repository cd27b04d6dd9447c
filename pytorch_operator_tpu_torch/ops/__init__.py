"""Kernels (``csrc/``, built by ``_build.py``) behind wrappers that keep a
plain PyTorch version for CPU tensors, and token sampling."""
