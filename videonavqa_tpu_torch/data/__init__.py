"""The host input pipeline: datasets on disk, batch loaders (Python and the
native VNR loader), frame buckets and prefetching to the device."""

from videonavqa_tpu_torch.data.pipeline import (  # noqa: F401
    BatchLoader, DataPaths, VNQADataset, load_json,
)
