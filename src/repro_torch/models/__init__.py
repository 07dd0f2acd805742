from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models import registry

__all__ = ["LayerSpec", "ModelConfig", "registry"]
