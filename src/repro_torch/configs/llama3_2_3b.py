"""llama3.2-3b — small llama3. [hf:meta-llama/Llama-3.2-3B]"""

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.registry import register


@register("llama3.2-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        rope_theta=5e5,
        tie_embeddings=True,
    )
