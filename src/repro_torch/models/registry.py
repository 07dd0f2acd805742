"""Architecture registry: name -> ModelConfig + build helpers."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

from repro_torch.models.config import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def names():
    _ensure_configs_loaded()
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    _ensure_configs_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def _ensure_configs_loaded():
    import repro_torch.configs  # noqa: F401  (registers all archs on import)


def exact_param_count(cfg: ModelConfig) -> int:
    """Parameter count from the port's own init shapes (no allocation):
    the same shape table ``stack.init_model`` fills."""
    from repro_torch.models import stack
    return sum(math.prod(spec.shape)
               for spec in stack.flat_param_specs(cfg).values())


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    n_layers = min(cfg.n_layers, 2 * len(cfg.pattern) + len(cfg.tail_specs))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=32,
        d_ff=256,
        d_ff_expert=0,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 8) if cfg.is_moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        ssm_state=32 if cfg.ssm_state else 0,
        ssm_heads=4 if cfg.ssm_state else 0,
        ssm_chunk=32,
        lru_width=0,
        window=min(cfg.window, 32) if cfg.window else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 16) if cfg.encoder_seq else 0,
        vision_seq=min(cfg.vision_seq, 16) if cfg.vision_seq else 0,
        vision_dim=64 if cfg.vision_dim else 0,
        max_seq_len=4096,
    )
