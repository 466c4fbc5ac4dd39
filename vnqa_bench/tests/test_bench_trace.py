"""The reduction of a traced window: the union of device intervals, the idle
gaps and what names them, kernels by name."""

import pytest

from vnqa_bench import trace


def test_union_of_intervals():
    assert trace.union_s([]) == 0.0
    assert trace.union_s([(0, 1), (2, 3)]) == 2.0
    assert trace.union_s([(0, 2), (1, 3)]) == 3.0            # overlapping streams
    assert trace.union_s([(0, 4), (1, 2), (3, 3.5)]) == 4.0    # nested
    assert trace.union_s([(2, 3), (0, 1), (0.5, 2.5)]) == 3.0  # unordered


def test_gaps():
    assert trace.gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]
    assert trace.gaps([(0, 5)], 0, 5) == []
    assert trace.gaps([(-1, 1), (0.5, 6)], 0, 5) == []


def make_trace():
    ops = [("int8_matmul_kernel<x>", 0.0, 0.4), ("film_reencode_kernel", 0.5, 0.7),
           ("Memcpy HtoD", 0.6, 0.65), ("vgg_block1_bf16_kernel", 0.9, 1.2),
           ("before", -1.0, -0.5)]
    spans = [("dispatch_batch", 0.35, 0.55), ("fetch", 0.7, 1.0), ("fetch", 0.72, 0.8)]
    return trace.Trace(ops, spans, 0.0, 1.0)


def test_busy_and_idle():
    t = make_trace()
    assert t.window_s == 1.0
    assert t.busy_s() == pytest.approx(0.4 + 0.2 + 0.1)      # clipped to the window
    assert t.kernel_s() == pytest.approx({"int8_matmul": 0.4, "film_reencode": 0.2,
                                          "vgg_block1": 0.3})
    assert t.launches() == {"int8_matmul": 1, "film_reencode": 1, "vgg_block1": 1}


def test_breakdown_names_gaps_by_the_innermost_span():
    b = make_trace().breakdown()
    assert b["device_ops"][0] == ["int8_matmul_kernel<x>", pytest.approx(0.4)]
    gaps = dict((round(s, 6), n) for n, s in b["idle_gaps"])
    assert gaps[0.2] == "host: fetch"                    # 0.7 - 0.9, middle 0.8: 'fetch' (0.7-1.0)
    assert gaps[0.1] == "host: dispatch_batch"           # 0.4 - 0.5
    assert len(b["idle_gaps"]) <= 10 and len(b["device_ops"]) <= 10


def test_kernel_names_map_every_kernel_of_the_package():
    assert set(trace.KERNEL_NAMES) == {"film_reencode", "attn_tail", "int8_matmul", "lstm",
                                       "vgg_block1"}
    assert trace.kernel_of("void cutlass::Kernel2<s8 gemm>") is None
