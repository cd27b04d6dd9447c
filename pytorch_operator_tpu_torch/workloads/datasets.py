"""Datasets of the in-tree workloads — the port of
``pytorch_operator_tpu/workloads/datasets.py``.

- :func:`digits`: the real 8×8 handwritten-digit set (1,797 images, 10
  classes) that ``mnist_train`` learns, split as the JAX function splits it,
  so both packages see the same bytes. The port reads its own copy of the
  data file, :data:`DIGITS_FILE`: the UCI "Optical Recognition of
  Handwritten Digits" set (E. Alpaydin, C. Kaynak; CC BY 4.0), byte for
  byte the ``digits.csv.gz`` that scikit-learn 1.9.0 ships in
  ``sklearn/datasets/data/`` (sha256 :data:`DIGITS_SHA256`): 1,797 rows of
  64 pixel counts in 0..16 and the label. The port does not import
  scikit-learn.
- :func:`synthetic_images`: the JAX module's numpy generator, so one seed
  gives the same bytes in both packages (the benches' synthetic mode and
  ``data/pack.py --dataset synthetic``).
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Tuple

import numpy as np

DIGITS_FILE = Path(__file__).resolve().with_name("digits.csv.gz")
DIGITS_SHA256 = "09f66e6debdee2cd2b5ae59e0d6abbb73fc2b0e0185d2e1957e9ebb51e23aa22"


def digits(split: str = "train", test_fraction: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
    """Real 8×8 handwritten digits, deterministic split, NHWC float32 in
    [0, 1] and int32 labels: the rows read as scikit-learn's ``load_digits``
    reads them (float64 by ``numpy.loadtxt``), divided by 16 in float64,
    permuted by ``default_rng(0)``, the first ``int(N · test_fraction)`` the
    test split."""
    with gzip.open(DIGITS_FILE, "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    x = (data[:, :-1].reshape(-1, 8, 8, 1) / 16.0).astype(np.float32)
    y = data[:, -1].astype(int).astype(np.int32)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_test = int(len(x) * test_fraction)
    if split == "train":
        return x[n_test:], y[n_test:]
    if split == "test":
        return x[:n_test], y[:n_test]
    raise ValueError(f"unknown split {split!r}")


def synthetic_images(
    batch: int, height: int, width: int, classes: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Random NHWC f32 images and int32 labels for the synthetic-data mode,
    drawn as the JAX function draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, height, width, 3), dtype=np.float32)
    y = rng.integers(0, classes, size=(batch,), dtype=np.int32)
    return x, y
