"""Pack a text file into the native loader's array-file format — the port of
``pytorch_operator_tpu/data/pack.py``'s ``--dataset text``.

Usage::

    python -m pytorch_operator_tpu_torch.data.pack --dataset text \\
        --input corpus.txt --seq-len 512 --out corpus.bin

The output is ``<out>`` plus a ``<out>.meta.json`` sidecar: int32 byte-level
token records (vocab 256) of ``--seq-len`` tokens, the data of
``llama_train --data-file``/``--eval-file``. ``--dataset digits`` and
``synthetic`` need the image datasets of the other models and are refused
(:data:`REFUSED_DATASETS`).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from .array_file import pack_arrays

# Datasets of the JAX tool that the port does not pack yet, with the ROADMAP
# item each waits for.
REFUSED_DATASETS = {
    "digits": "the other models and workloads (workloads/datasets.py)",
    "synthetic": "the other models and workloads (workloads/datasets.py)",
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument(
        "--dataset", choices=("digits", "synthetic", "text"), default="digits",
        help="text is ported; digits and synthetic are refused",
    )
    p.add_argument(
        "--input", default=None,
        help="text: path to a UTF-8/byte file to pack as LM training data",
    )
    p.add_argument(
        "--seq-len", type=int, default=512,
        help="text: tokens per record (byte-level, vocab 256)",
    )
    args = p.parse_args(argv)
    if args.dataset in REFUSED_DATASETS:
        raise NotImplementedError(
            f"--dataset {args.dataset} is not ported yet "
            f"(ROADMAP.md: {REFUSED_DATASETS[args.dataset]})"
        )
    if not args.input:
        raise SystemExit("--dataset text needs --input FILE")
    data = Path(args.input).read_bytes()
    S = args.seq_len
    n = len(data) // S  # the tail shorter than one record is dropped
    if n == 0:
        raise SystemExit(f"{args.input}: {len(data)} bytes < one record of {S}")
    tokens = np.frombuffer(data[: n * S], np.uint8).astype(np.int32).reshape(n, S)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    meta = pack_arrays(args.out, {"tokens": tokens})
    print(f"packed {meta.n_records} records ({meta.record_bytes} B each) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
