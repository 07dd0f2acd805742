"""The paper's own evaluation models (Table 2): Mixtral-architecture MoEs.

| Model      | #Layers | Hidden | #Experts | #Params |
|------------|---------|--------|----------|---------|
| Mixtral-W1 | 4       | 2048   | 12       | 2.2B    |
| Mixtral-W2 | 4       | 2048   | 24       | 4.3B    |
| Mixtral-D1 | 8       | 1024   | 24       | 2.1B    |
| Mixtral-D2 | 6       | 1024   | 18       | 1.2B    |
| Mixtral-D3 | 8       | 1024   | 40       | 3.5B    |

Top-2 gating (paper §6.1), Mixtral ratios: d_ff = 3.5 d, heads = d/128,
kv = heads/4, vocab 32000.
"""

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.registry import register


def _mixtral(name, n_layers, d_model, n_experts) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="moe",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=d_model // 128,
        n_kv_heads=max(d_model // 512, 1),
        d_ff=int(3.5 * d_model),
        d_ff_expert=int(3.5 * d_model),
        vocab_size=32000,
        pattern=(LayerSpec(mixer="attn", ffn="moe"),),
        n_experts=n_experts,
        top_k=2,
        rope_theta=1e6,
    )


@register("mixtral-w1")
def config_w1() -> ModelConfig:
    return _mixtral("mixtral-w1", 4, 2048, 12)


@register("mixtral-w2")
def config_w2() -> ModelConfig:
    return _mixtral("mixtral-w2", 4, 2048, 24)


@register("mixtral-d1")
def config_d1() -> ModelConfig:
    return _mixtral("mixtral-d1", 8, 1024, 24)


@register("mixtral-d2")
def config_d2() -> ModelConfig:
    return _mixtral("mixtral-d2", 6, 1024, 18)


@register("mixtral-d3")
def config_d3() -> ModelConfig:
    return _mixtral("mixtral-d3", 8, 1024, 40)
