"""recurrentgemma-9b — RG-LRU + local attention, 1:2. [arXiv:2402.19427]"""

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.registry import register


@register("recurrentgemma-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,         # 12 x (rglru, rglru, local_attn) + 2 rglru tail
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,        # MQA
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        pattern=(
            LayerSpec(mixer="rglru", ffn="dense"),
            LayerSpec(mixer="rglru", ffn="dense"),
            LayerSpec(mixer="local_attn", ffn="dense"),
        ),
        window=2048,
        lru_width=4096,
        conv_width=4,
        emb_scale=True,
        tie_embeddings=True,
        rope_theta=1e4,
    )
