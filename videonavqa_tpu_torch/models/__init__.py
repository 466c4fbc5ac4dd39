from videonavqa_tpu_torch.models.base import MODEL_REGISTRY, ModelConfig, get_model  # noqa: F401

# Import for registration side effects.
from videonavqa_tpu_torch.models import (  # noqa: F401,E402
    concat2d, concat3d, film, mac, q_only_bow, q_only_lstm, time_multi_hop, v_only_cnn2d_lstm,
    v_only_cnn3d)
