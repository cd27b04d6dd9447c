"""Per-process data feeding for data-parallel training — the port of
``pytorch_operator_tpu/parallel/data.py``.

Every process holds the identical host batch (same generator, or the same
file, seed and loader); each takes its own rows. JAX assembles the rows
into one global Array; here a rank's batch is its rows on its device.
"""

from __future__ import annotations

import numpy as np


def _world(process_index, process_count) -> tuple:
    if process_index is None or process_count is None:
        from .collectives import world

        process_index, process_count = world()
    return int(process_index), int(process_count)


def global_batch(batch, process_index=None, process_count=None) -> np.ndarray:
    """This process's rows of a host batch that every process holds: rows
    ``pid·per:(pid+1)·per`` with ``per = rows / processes`` (the JAX
    function's process slice). The world defaults to the joined one."""
    batch = np.asarray(batch)
    pid, pcount = _world(process_index, process_count)
    if pcount == 1:
        return batch
    n = batch.shape[0]
    if n % pcount != 0:
        raise ValueError(f"global batch size {n} must divide evenly across {pcount} processes")
    per = n // pcount
    return batch[pid * per : (pid + 1) * per]


def put_global(batch, device, process_index=None, process_count=None):
    """This process's rows of the host batch as a tensor on ``device``."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(global_batch(batch, process_index, process_count))).to(device)


def shard_batch_size(global_size: int, mesh, axis: str = "dp") -> int:
    """Check that a global batch divides the extent of ``axis``; return the
    rows a shard. ``mesh`` is a ``DeviceMesh`` or a mapping of axis sizes."""
    from .mesh import axis_sizes

    extent = axis_sizes(mesh).get(axis, 1)
    if global_size % extent != 0:
        raise ValueError(f"global batch {global_size} must be divisible by {axis}={extent}")
    return global_size // extent


def epoch_batches(x, y, batch_size: int, *, seed: int, drop_last: bool = True):
    """Deterministic shuffled minibatches: the same permutation on every
    process (same host dataset, same seed)."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    end = (n // batch_size) * batch_size if drop_last else n
    for i in range(0, end, batch_size):
        idx = perm[i : i + batch_size]
        yield x[idx], y[idx]
