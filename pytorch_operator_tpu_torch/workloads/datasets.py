"""Datasets of the image workloads — the port of
``pytorch_operator_tpu/workloads/datasets.py``.

- :func:`synthetic_images`: the JAX module's numpy generator, so one seed
  gives the same bytes in both packages (the benches' synthetic mode and
  ``data/pack.py --dataset synthetic``).
- ``digits`` (scikit-learn's 8×8 handwritten digits) needs scikit-learn,
  which the port does not import; it is refused by name until the MNIST
  slice (:data:`REFUSED`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Datasets of the JAX module that the port refuses, with the ROADMAP item each
# waits for.
REFUSED = {"digits": "Queue 1 item 2, the MNIST slice (scikit-learn's digits)"}


def digits(split: str = "train", test_fraction: float = 0.2):
    raise NotImplementedError(f"the digits dataset is not ported yet (ROADMAP.md: {REFUSED['digits']})")


def synthetic_images(
    batch: int, height: int, width: int, classes: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Random NHWC f32 images and int32 labels for the synthetic-data mode,
    drawn as the JAX function draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, height, width, 3), dtype=np.float32)
    y = rng.integers(0, classes, size=(batch,), dtype=np.int32)
    return x, y
