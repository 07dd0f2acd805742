"""qwen3-32b — dense GQA with qk_norm. [hf:Qwen/Qwen3-32B]"""

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.registry import register


@register("qwen3-32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,        # explicit (qwen3 decouples from d_model/n_heads)
        d_ff=25600,
        vocab_size=151936,
        pattern=(LayerSpec(mixer="attn", ffn="dense"),),
        qk_norm=True,
        rope_theta=1e6,
    )
