"""The measured package's device spans against the benchmark's own timing on
the card: a ``stem`` span recorded with ``device=True`` around
``stem_features`` reads, by its CUDA events, what ``cuda_ms`` reads of the
same call. Skips without a CUDA card."""

import pytest
import torch

from vnqa_bench import inputs
from vnqa_bench.reference import stem as ref_stem
from vnqa_bench.trace import cuda_ms

SEED = 2**31 + 77


@pytest.mark.card
def test_stem_device_span_agrees_with_cuda_ms(card):
    from videonavqa_tpu_torch.stem import stem_features
    from videonavqa_tpu_torch.utils import logging as tlog

    det_p, det_s = ref_stem.detector_shapes(512)
    stem = (inputs.make_weights(ref_stem.vgg_shapes(), SEED, 12, card),
            inputs.make_weights(det_p, SEED, 13, card),
            inputs.make_weights(det_s, SEED, 14, card))
    video = inputs.videos(8, SEED, card)[:, :inputs.MAX_FRAMES].to(card).float() / 255.0

    def run():
        return stem_features(*stem, video, dtype=torch.bfloat16, use_kernel=True)

    by_events = cuda_ms(run)
    tlog.trace_on()
    try:
        with torch.no_grad():
            for _ in range(3):
                with tlog.span("stem", device=True):
                    run()
        torch.cuda.synchronize(card)
        spans = tlog.trace_drain()["spans"]
    finally:
        tlog.trace_off()
    assert [s["name"] for s in spans] == ["stem"] * 3
    by_span = sum(s["device_ms"] for s in spans) / 3
    assert by_span == pytest.approx(by_events, rel=0.1), (by_span, by_events)
