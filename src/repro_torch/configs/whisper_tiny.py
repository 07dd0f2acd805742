"""whisper-tiny — enc-dec audio backbone; conv frontend stubbed to
precomputed frame embeddings per the brief. [arXiv:2212.04356]"""

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.registry import register


@register("whisper-tiny")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,          # decoder layers
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        pattern=(LayerSpec(mixer="attn", ffn="dense", cross_attn=True),),
        n_encoder_layers=4,
        encoder_seq=1500,    # stub frontend: 30 s of 10 ms mel frames / 2
        norm="layernorm",
        mlp_act="gelu",
        rope_theta=0.0,      # no rope
        learned_pos=True,    # learned absolute positions
        max_seq_len=32768,   # stretched for the assigned decode_32k cell
    )
