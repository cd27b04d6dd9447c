"""The benchmark of ``pytorch_operator_tpu_torch`` on NVIDIA H100 cards.

One run trains one cell of ``BENCHMARK.json`` for a fixed window and prints
one JSON line::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by name: ``configs/<name>.json``,
``mixes/<traffic>.json``, ``checks/<cell>.json`` (the limits of the
correctness comparison) and ``metrics/<metric>.py`` (a reader with
``read(run) -> float | None``). The yardstick (weights and tokens from the
seed, the plain f32 reference, the FLOP and byte counts, the trace
arithmetic) lives here too and imports nothing of JAX; the reference imports
nothing of the port either.
"""
