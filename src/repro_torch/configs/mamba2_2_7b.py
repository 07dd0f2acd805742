"""mamba2-2.7b — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.registry import register


@register("mamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=80,          # din / ssm_head_dim = 5120 / 64
        n_kv_heads=80,
        head_dim=64,
        d_ff=0,              # no separate MLP: the SSD block is the layer
        vocab_size=50280,
        pattern=(LayerSpec(mixer="ssd", ffn="none"),),
        ssm_state=128,
        ssm_heads=80,
        ssm_head_dim=64,
        ssm_chunk=256,
        ssm_expand=2,
        conv_width=4,
        tie_embeddings=True,
        rope_theta=0.0,      # no positional encoding (recurrence carries it)
    )
