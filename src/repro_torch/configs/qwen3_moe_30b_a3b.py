"""qwen3-moe-30b-a3b — 128 experts top-8, fine-grained. [hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.registry import register


@register("qwen3-moe-30b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        d_ff_expert=768,
        vocab_size=151936,
        pattern=(LayerSpec(mixer="attn", ffn="moe"),),
        n_experts=128,
        top_k=8,
        qk_norm=True,
        rope_theta=1e6,
        capacity_factor=1.25,
    )
