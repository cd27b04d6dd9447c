"""pytorch_operator_tpu_torch — the PyTorch/CUDA port of tpujob's compute stack.

The JAX package ``pytorch_operator_tpu`` beside it is the reference: every
module here mirrors a module there by path and name, and the tests hold the
two against each other on the same inputs. This package imports ``torch``,
numpy and the standard library only — never jax, flax, optax, orbax, or
anything of ``pytorch_operator_tpu``; what it needs of a framework-free
module there it keeps as its own copy.

- ``runtime`` — device resolution (``device.py``, the counterpart of
  ``runtime/backend.py``) and the worker side of the supervisor's status
  channel (``rendezvous.py``).
- ``ops``     — hand-written Hopper kernels (``csrc/*.cu``, built with nvcc
  at first use by ``_build.py``) behind wrappers that keep a plain PyTorch
  version for CPU tensors (flash attention forward and backward), the
  chunked-vocab loss, and token sampling.
- ``models``  — the Llama decoder with its KV-cache decode path, and the
  loader that turns a JAX param tree into this package's state dict.
- ``parallel`` — the mixture-of-experts layer on one device (``moe.py``).
- ``workloads`` — runnable entry points (``generate``, ``llama_train``) and
  the training loop they share (``trainer``).

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--device cpu`` or ``TPUJOB_PLATFORM=cpu``); with no GPU and no such
request they raise instead of falling back.
"""

__version__ = "0.1.0"
