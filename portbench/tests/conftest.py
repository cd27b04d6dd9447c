"""Shared helpers of the benchmark's CPU tests: a cell of BENCHMARK.json cut
to a size a test run holds, with its layout, dtypes and limits kept."""

import dataclasses

import pytest
import torch

from portbench import harness

CELLS = ("mistral-7b.train.s32k", "mistral-nemo-12b.train.s4k", "mistral-7b.train.s4k")
TINY = dict(hidden_size=64, intermediate_size=160, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, vocab_size=512)
# Heads of the cells' width (128): rounding noise averages over as many
# elements of a head as in the cells.
SMALL = dict(hidden_size=512, intermediate_size=1536, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=128, vocab_size=4096)


def tiny_cell(name: str, root=harness.ROOT, size=TINY, seq_len=64, **config) -> harness.Cell:
    """``name``'s cell at ``size``'s widths, two rows of ``seq_len`` tokens
    (one row where the cell has one), and ``config`` over its
    configuration."""
    cell = harness.load_cell(name, root)
    mix = {**cell.mix, "batch": min(cell.mix["batch"], 2), "seq_len": seq_len}
    return dataclasses.replace(cell, config={**cell.config, **size, **config}, mix=mix)


def run_tiny(cell: harness.Cell, seed: int = 2**31 + 11, traced: bool = False) -> dict:
    return harness.run_cell(cell, seed, 0.2, traced, torch.device("cpu"), 0.0, log=lambda m: None)


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param
