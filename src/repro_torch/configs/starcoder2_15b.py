"""starcoder2-15b — GQA + RoPE code model. [arXiv:2402.19173; hf]"""

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.registry import register


@register("starcoder2-15b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        rope_theta=1e5,
        norm="layernorm",
        mlp_act="gelu",
    )
