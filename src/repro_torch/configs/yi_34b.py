"""yi-34b — llama-arch dense GQA. [arXiv:2403.04652; hf]"""

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.registry import register


@register("yi-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        rope_theta=5e6,
    )
