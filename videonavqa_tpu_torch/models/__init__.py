from videonavqa_tpu_torch.models.base import MODEL_REGISTRY, ModelConfig, get_model  # noqa: F401

# Import for registration side effects.
from videonavqa_tpu_torch.models import film  # noqa: F401,E402
