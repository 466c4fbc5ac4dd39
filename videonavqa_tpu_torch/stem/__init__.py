"""The frozen visual stem: VGG-16 partial, then ObjDetectCNN's features."""

from videonavqa_tpu_torch.stem.vgg import (  # noqa: F401
    VGG_PARTIAL_CFG, init_vgg_partial, vgg_partial, vgg_partial_block1_kernel,
)
from videonavqa_tpu_torch.stem.obj_detector import (  # noqa: F401
    init_obj_detector, obj_detector, obj_detector_features, stem_features,
)

# The seed of the reference init of a frozen stem that has no weights on disk.
STEM_SEED = 1234
