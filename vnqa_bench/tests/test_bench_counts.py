"""The yardstick's counts against sums written out by hand at small shapes."""

import math

import pytest

from vnqa_bench import counts


def test_least_s_takes_the_slower_bound():
    assert counts.least_s(3.35e12, 0, counts.BF16_FLOPS) == pytest.approx(1.0)
    assert counts.least_s(0, 989e12, counts.BF16_FLOPS) == pytest.approx(1.0)
    assert counts.least_s(3.35e12, 2 * 989e12, counts.BF16_FLOPS) == pytest.approx(2.0)


def test_film_reencode_counts():
    # B 2, Tq 3, H 4, F 5 frames, q_lens (1, 3): 5 x 4 steps
    B, Tq, H, F = 2, 3, 4, 5
    steps = F * (1 + 3)
    ops = steps * (2 * 4 * H * H + 12 * H)
    nbytes = 4 * (Tq * B * 4 * H + 4 * H * H + 4 * H + B + F * B * H)
    want = max(nbytes / counts.HBM_BYTES_PER_S, ops / counts.F32_FLOPS)
    assert counts.film_reencode(B, Tq, H, F, [1, 3]) == pytest.approx(want)


def test_attn_tail_counts():
    B, T, A, S = 2, 3, 4, 5
    per_row = 6 * T + 2 * T * A + 2 * 4 * A * A + 4 * A + S * (2 * 4 * A * A + 12 * A)
    nbytes = 4 * (B * T * A + 2 * B * T + 2 * 4 * A * A + 4 * A + B * S * A)
    want = max(nbytes / counts.HBM_BYTES_PER_S, B * per_row / counts.F32_FLOPS)
    assert counts.attn_tail(B, T, A, S) == pytest.approx(want)


def test_int8_matmul_counts():
    M, K, N = 1000, 128, 256
    nbytes = M * K * 2 + N * K + 8 * N + 8 + M * N * 2 + M * N
    want = max(nbytes / counts.HBM_BYTES_PER_S, 2 * M * K * N / counts.INT8_OPS)
    assert counts.int8_matmul(M, K, N, 2) == pytest.approx(want)
    # bytes bound: every byte counted once; f32 input reads twice the bf16 bytes of x
    assert counts.int8_matmul(M, K, N, 4) > counts.int8_matmul(M, K, N, 2)


def test_vgg_block1_counts():
    ops = 2 * 160 * 208 * 64 * 27 + 2 * 160 * 208 * 64 * 576
    assert counts.vgg_block1(1) >= ops / counts.BF16_FLOPS
    assert counts.vgg_block1(10) == pytest.approx(10 * ops / counts.BF16_FLOPS)


def test_conv_and_stem_ops():
    assert counts.conv_ops(2, 3, 4, 5, 3) == 2 * 2 * 3 * 4 * 5 * 9
    vgg = 2 * 9 * (160 * 208 * (3 * 64 + 64 * 64) + 80 * 104 * (64 * 128 + 128 * 128))
    det = 2 * 9 * (40 * 52 * (128 * 8 + 8 * 8) + 2 * 20 * 26 * 64 + 2 * 10 * 13 * 64)
    assert counts.stem_ops_per_frame(8) == vgg + det


CFG = dict(num_res_block_channels=4, num_input_channels=2, num_res_blocks=2, embed_size=3,
           hidden_size=2, at_hidden_size=2, max_num_frames=5, num_classes=7)


def test_film_attn_ops_per_video():
    v, q, P = 3, 2, 130
    trunk = v * (2 * P * 2 * 4 * 9 + 2 * (2 * P * 4 * 4 + 2 * P * 4 * 4 * 9))
    rest = (2 * q * 3 * 4 * 2 + v * q * (2 * 4 * 2 * 2 + 12 * 2) + v * 2 * 2 * 2 * 4 * 2
            + v * (2 * P * 4 * 2 + 2 * 2) + 5 * (2 * 2 + 4 * v * 2 + 2 * 4 * 2 * 4 + 12 * 2)
            + 2 * 5 * 2 * 7)
    want = trunk / counts.INT8_OPS + rest / counts.BF16_FLOPS
    assert counts.film_attn_least_s(CFG, v, q, stem=False) == pytest.approx(want)
    with_stem = want + v * counts.stem_ops_per_frame(2) / counts.BF16_FLOPS
    assert counts.film_attn_least_s(CFG, v, q, stem=True) == pytest.approx(with_stem)


def test_mac_train_is_three_forwards_and_the_stem():
    cfg = dict(mac_dim=4, embed_size=3, num_input_channels=2, mac_max_step=2, num_classes=7)
    fwd = counts.mac_forward_ops(cfg, 3, 2)
    assert fwd > 0
    least = counts.mac_train_least_s(cfg, 3, 2)
    assert least == pytest.approx((3 * fwd + 3 * counts.stem_ops_per_frame(2)) / counts.BF16_FLOPS)
    assert not math.isnan(least)
