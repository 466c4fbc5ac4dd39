"""Host milliseconds of one InferenceEngine.dispatch_batch call (staging,
copy and enqueue), the mean over the window's batches, from host-clock spans
the benchmark puts around each call."""


def read(rec):
    spans = rec.get("engine_host_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
