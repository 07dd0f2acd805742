"""dbrx-132b — MoE, 16 experts top-4 fine-grained. [hf:databricks/dbrx-base]"""

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.registry import register


@register("dbrx-132b")
def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        d_ff_expert=10752,
        vocab_size=100352,
        pattern=(LayerSpec(mixer="attn", ffn="moe"),),
        n_experts=16,
        top_k=4,
        rope_theta=5e5,
        capacity_factor=1.25,
    )
