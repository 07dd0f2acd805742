"""llama-3.2-vision-90b — dense backbone with interleaved cross-attention
image layers (every 5th); vision tower stubbed to precomputed patch
embeddings per the brief. [hf:meta-llama/Llama-3.2-90B-Vision]"""

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.registry import register


@register("llama-3.2-vision-90b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,        # 20 x (4 self-attn + 1 cross-attn block)
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        pattern=(
            LayerSpec(mixer="attn", ffn="dense"),
            LayerSpec(mixer="attn", ffn="dense"),
            LayerSpec(mixer="attn", ffn="dense"),
            LayerSpec(mixer="attn", ffn="dense"),
            LayerSpec(mixer="none", ffn="dense", cross_attn=True),
        ),
        vision_seq=1601,     # (560/14)^2 + cls, one tile
        vision_dim=1280,
        rope_theta=5e5,
    )
