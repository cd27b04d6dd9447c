"""pytorch_operator_tpu_torch — the PyTorch/CUDA port of tpujob's compute stack.

The JAX package ``pytorch_operator_tpu`` beside it is the reference: every
module here mirrors a module there by path and name, and the tests hold the
two against each other on the same inputs. This package imports ``torch``,
numpy and the standard library only — never jax, flax, optax, orbax, or
anything of ``pytorch_operator_tpu``; what it needs of a framework-free
module there it keeps as its own copy.

- ``runtime`` — device resolution (``device.py``, the counterpart of
  ``runtime/backend.py``: a rank's card in a world) and the worker side of
  the supervisor's world and status channel (``rendezvous.py``: the
  ``torch.distributed`` join, the resize fence, ``finalize``, the records).
- ``ops``     — hand-written Hopper kernels (``csrc/*.cu``, built with nvcc
  at first use by ``_build.py``) behind wrappers that keep a plain PyTorch
  version for CPU tensors (flash attention forward and backward), the
  chunked-vocab loss, and token sampling.
- ``models``  — the Llama decoder with its KV-cache decode path, ResNet and
  ViT, and the loaders that turn a JAX param tree into this package's state
  dicts.
- ``parallel`` — meshes over the ranks, collectives, each rank's rows, FSDP2
  over the data axes, and the mixture-of-experts layer on one device.
- ``workloads`` — runnable entry points (``generate``, ``llama_train``,
  ``serve``, ``quality_eval``, ``smoke_dist``, ``resnet_bench``,
  ``resnet_ab``, ``vit_bench``, ``latency_probe``) and the training loop and
  image-bench parts they share (``trainer``).

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--device cpu`` or ``TPUJOB_PLATFORM=cpu``); with no GPU and no such
request they raise instead of falling back.
"""

__version__ = "0.1.0"
