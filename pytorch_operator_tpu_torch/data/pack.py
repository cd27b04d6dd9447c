"""Pack a dataset into the native loader's array-file format — the port of
``pytorch_operator_tpu/data/pack.py``.

Usage::

    python -m pytorch_operator_tpu_torch.data.pack --out digits.bin --dataset digits
    python -m pytorch_operator_tpu_torch.data.pack --dataset text \\
        --input corpus.txt --seq-len 512 --out corpus.bin
    python -m pytorch_operator_tpu_torch.data.pack --dataset synthetic \\
        --n 4096 --height 32 --width 32 --classes 10 --out syn.bin

The output is ``<out>`` plus a ``<out>.meta.json`` sidecar, the same bytes
as the JAX tool's for the same arguments. ``digits``: the ``--split``
(train or test) of ``workloads.datasets.digits``, an f32 ``x`` image
(8×8×1) and an int32 ``y`` label a record, the data of ``mnist_train
--data-file``. ``text``: int32 byte-level token records (vocab 256) of
``--seq-len`` tokens, the data of ``llama_train --data-file``/
``--eval-file``. ``synthetic``: ``--n`` records of an f32 ``x`` image
(H×W×3) and an int32 ``y`` label from ``workloads.datasets.synthetic_images``,
the data of ``resnet_bench``/``vit_bench --data-file``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from .array_file import pack_arrays


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--dataset", choices=("digits", "synthetic", "text"), default="digits")
    p.add_argument("--split", default="train", choices=("train", "test"), help="digits: the split")
    p.add_argument("--n", type=int, default=4096, help="synthetic: record count")
    p.add_argument("--height", type=int, default=32)
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--input", default=None,
        help="text: path to a UTF-8/byte file to pack as LM training data",
    )
    p.add_argument(
        "--seq-len", type=int, default=512,
        help="text: tokens per record (byte-level, vocab 256)",
    )
    args = p.parse_args(argv)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    if args.dataset in ("digits", "synthetic"):
        from ..workloads.datasets import digits, synthetic_images

        if args.dataset == "digits":
            x, y = digits(args.split)
        else:
            x, y = synthetic_images(args.n, args.height, args.width, args.classes, seed=args.seed)
        meta = pack_arrays(args.out, {"x": x, "y": y})
        print(f"packed {meta.n_records} records ({meta.record_bytes} B each) -> {args.out}")
        return 0
    if not args.input:
        raise SystemExit("--dataset text needs --input FILE")
    data = Path(args.input).read_bytes()
    S = args.seq_len
    n = len(data) // S  # the tail shorter than one record is dropped
    if n == 0:
        raise SystemExit(f"{args.input}: {len(data)} bytes < one record of {S}")
    tokens = np.frombuffer(data[: n * S], np.uint8).astype(np.int32).reshape(n, S)
    meta = pack_arrays(args.out, {"tokens": tokens})
    print(f"packed {meta.n_records} records ({meta.record_bytes} B each) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
