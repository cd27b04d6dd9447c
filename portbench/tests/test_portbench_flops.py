"""The frozen counters against the numbers worked out by hand."""

import math

import pytest

from portbench import flops, harness


def _config(name):
    return harness.load_cell(name).config


def test_mistral_7b_s32k_step_flops_match_the_hand_count():
    f = flops.step_model_flops(_config("mistral-7b.train.s32k"), 1, 32768)
    # 6 · 32,768 tokens · 1.8794e9 matmul parameters (8 layers of 218.1e6, head 134.2e6)
    assert f["matmul"] == pytest.approx(3.694e14, rel=1e-3)
    # 3 · 2·S²·H·Dh · 8 layers
    assert f["attention"] == pytest.approx(2.111e14, rel=1e-3)
    assert f["total"] == pytest.approx(5.805e14, rel=1e-3)


def test_mistral_nemo_s4k_step_flops_match_the_hand_count():
    f = flops.step_model_flops(_config("mistral-nemo-12b.train.s4k"), 4, 4096)
    assert f["total"] == pytest.approx(2.08e14, rel=2e-3)


def test_matmul_params_exclude_the_embedding():
    cfg = _config("mistral-7b.train.s32k")
    per_layer = 4096 * (4096 + 2 * 1024) + 4096 * 4096 + 3 * 4096 * 14336
    assert flops.matmul_params(cfg) == 8 * per_layer + 32768 * 4096


def test_flash_least_work_is_three_causal_forwards_and_each_tensor_once():
    B, S, H, KH, Dh = 1, 32768, 32, 8, 128
    f, nbytes = flops.flash_least_work(B, S, H, KH, Dh)
    assert f == 3 * 2 * B * S * S * H * Dh
    # q, o, do read; o, dq written: five [B,S,H,Dh]; k, v read, dk, dv written: four [B,S,KH,Dh]
    assert nbytes == 2 * B * S * Dh * (5 * H + 4 * KH)
    # compute-bound at these shapes
    assert f / flops.PEAK_BF16_FLOPS > nbytes / flops.PEAK_HBM_BYTES_S


def test_loss_head_least_work_and_roofline_share():
    N, D, V = 4 * 4095, 5120, 131072
    f, nbytes = flops.loss_head_least_work(N, D, V)
    assert f == 6 * N * D * V
    assert nbytes == N * D * 2 + D * V * 4 + N * 8
    least = f / flops.PEAK_BF16_FLOPS
    assert flops.roofline_pct(f, nbytes, 4 * least) == pytest.approx(25.0)


def test_mfu_of_a_step_at_the_peak_is_100():
    assert flops.mfu_pct(flops.PEAK_BF16_FLOPS * 3.0, 3.0) == pytest.approx(100.0)
    assert math.isclose(flops.least_seconds(989e12, 0), 1.0)
