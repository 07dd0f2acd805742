"""Model configuration.

One `ModelConfig` describes any architecture in the zoo. The layer stack is a
repeating `pattern` of `LayerSpec`s (scanned with stacked params for compile
efficiency) plus an optional unrolled `tail`. This covers:

  * uniform decoder stacks           pattern=(attn+ffn,) x n
  * recurrentgemma 1:2 hybrid        pattern=(rglru, rglru, local_attn)
  * llama-3.2-vision cross-attn      pattern=(attn, attn, attn, attn, xattn)
  * mamba2                           pattern=(ssd,)
  * whisper enc/dec                  separate encoder stack + decoder stack
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

MixerKind = Literal["attn", "local_attn", "rglru", "ssd", "none"]
FFNKind = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One transformer-block position inside the repeating pattern."""

    mixer: MixerKind = "attn"
    ffn: FFNKind = "dense"
    cross_attn: bool = False  # adds a cross-attention sub-layer (enc-dec / VLM)
    causal: Optional[bool] = None  # None -> inherit ModelConfig.causal

    def tag(self) -> str:
        t = self.mixer
        if self.cross_attn:
            t += "+x"
        t += f"+{self.ffn}"
        return t


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # Layer layout ----------------------------------------------------------
    pattern: tuple = (LayerSpec(),)  # repeated floor(n_layers/len) times
    # remaining n_layers % len(pattern) layers reuse pattern prefix, unrolled

    # MoE --------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0  # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # Attention --------------------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 1e6
    learned_pos: bool = False  # learned absolute positions (whisper)
    window: int = 0  # sliding window for local_attn layers
    causal: bool = True
    attn_logit_softcap: float = 0.0

    # SSM (mamba2 SSD) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0  # 0 -> n_heads
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    ssm_expand: int = 2

    # RG-LRU (recurrentgemma) --------------------------------------------------
    lru_width: int = 0  # 0 -> d_model

    # Enc-dec (whisper) ----------------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # fixed encoder length (stubbed audio frontend frames)

    # VLM ------------------------------------------------------------------------
    vision_seq: int = 0  # number of precomputed image patch embeddings
    vision_dim: int = 0  # dim of stub patch embeddings (0 -> d_model)

    # Misc -------------------------------------------------------------------
    mlp_act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    emb_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma-style)
    max_seq_len: int = 524_288
    unroll: bool = False  # python-loop the layer stack instead of lax.scan
    # (used by the dry-run's cost extrapolation: XLA HloCostAnalysis counts
    # while bodies once, so FLOPs are measured on unrolled 1/2-repeat
    # variants and extrapolated; production path stays scanned.)

    # ----------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.ssm_heads == 0:
            object.__setattr__(self, "ssm_heads", self.n_heads)
        if self.d_ff_expert == 0:
            object.__setattr__(self, "d_ff_expert", self.d_ff)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # Layout helpers ---------------------------------------------------------
    @property
    def n_pattern_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_specs(self) -> tuple:
        r = self.n_layers % len(self.pattern)
        return self.pattern[:r]

    def layer_layout(self) -> list:
        """Full per-layer list of LayerSpec, length n_layers."""
        out = list(self.pattern) * self.n_pattern_repeats + list(self.tail_specs)
        assert len(out) == self.n_layers
        return out

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 1

    @property
    def attention_free(self) -> bool:
        return all(s.mixer in ("ssd", "none") and not s.cross_attn
                   for s in self.layer_layout())

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer does full global attention (long-context capable)."""
        return all(s.mixer in ("ssd", "local_attn", "rglru", "none")
                   for s in self.layer_layout()) and not self.is_encdec

    # Analytics ---------------------------------------------------------------
    def param_count(self) -> int:
        """Analytical parameter count (embedding + per-layer)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        for spec in self.layer_layout():
            total += self._mixer_params(spec) + self._ffn_params(spec)
            total += 2 * d  # two norms
            if spec.cross_attn:
                total += self._xattn_params() + d
        # encoder stack (whisper)
        for _ in range(self.n_encoder_layers):
            total += self._mixer_params(LayerSpec()) + self._ffn_params(
                LayerSpec(ffn="dense")) + 2 * self.d_model
        return total

    def _mixer_params(self, spec: LayerSpec) -> int:
        d, hd = self.d_model, self.head_dim
        if spec.mixer in ("attn", "local_attn"):
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            qknorm = 2 * hd if self.qk_norm else 0
            return q + kv + o + qknorm
        if spec.mixer == "rglru":
            w = self.lru_width
            # linear in/out + conv1d + RG-LRU gates (a-gate, i-gate) + Lambda
            return 2 * d * w + self.conv_width * w + 2 * w * w // 8 * 8 + w
        if spec.mixer == "ssd":
            din = self.ssm_expand * d
            nh, hs = self.ssm_heads, self.ssm_state
            # in_proj -> [z, x, B, C, dt]; conv over (x,B,C); out_proj
            zxbcdt = d * (2 * din + 2 * nh * hs // nh * nh + nh)
            zxbcdt = d * (2 * din + 2 * self.ssm_state + nh)  # grouped B,C (1 group)
            conv = self.conv_width * (din + 2 * self.ssm_state)
            out = din * d
            extra = 2 * nh + din  # A_log, D, norm
            return zxbcdt + conv + out + extra
        return 0

    def _xattn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + \
            self.n_heads * hd * d

    def _ffn_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        if spec.ffn == "dense":
            mult = 3 if self.mlp_act == "swiglu" else 2
            return mult * d * self.d_ff
        if spec.ffn == "moe":
            mult = 3 if self.mlp_act == "swiglu" else 2
            return self.n_experts * mult * d * self.d_ff_expert + \
                d * self.n_experts  # router
        return 0

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        total = self.param_count()
        mult = 3 if self.mlp_act == "swiglu" else 2
        per_expert = mult * self.d_model * self.d_ff_expert
        n_moe_layers = sum(1 for s in self.layer_layout() if s.ffn == "moe")
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_expert
        return total - inactive

    def flops_per_token_train(self, seq_len: int) -> float:
        """Approx training FLOPs/token: 6*N_active + attention quadratic term."""
        flops = 6.0 * self.active_param_count()
        # attention: 2*s*d_head*n_heads per token per attn layer, x2 (qk^T, av),
        # x3 (fwd + 2x bwd)
        for spec in self.layer_layout():
            if spec.mixer == "attn":
                eff = seq_len if self.causal else seq_len
                flops += 3 * 2 * 2 * self.n_heads * self.head_dim * eff / 2
            elif spec.mixer == "local_attn":
                w = min(self.window or seq_len, seq_len)
                flops += 3 * 2 * 2 * self.n_heads * self.head_dim * w
        return flops


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
