"""The yardstick: the card's published peaks and the operations and bytes
that a training step's work needs, computed from the model's sizes.

Recomputation, padding rows, capacity slack and the extra products of a
split-precision kernel are not work: a share computed from these counts
reads the same work whatever implements it."""

from __future__ import annotations

from perfbench.model import MoESpec

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
H100_PEAK_BF16 = 989e12      # FLOP/s, bf16 / fp16 tensor cores
H100_HBM_BW = 3.35e12        # bytes/s


def active_params(m: MoESpec) -> int:
    """Parameters a token's step multiplies by: the attention projections,
    the router, top_k experts' SwiGLU and the LM head (no embedding
    lookup)."""
    d, hd = m.d_model, m.head_dim
    attn = d * m.n_heads * hd * 2 + d * m.n_kv_heads * hd * 2
    per_layer = attn + d * m.n_experts + m.top_k * 3 * d * m.d_ff
    return m.n_layers * per_layer + m.vocab * d


def model_flops(m: MoESpec, B: int, S: int) -> float:
    """Model FLOPs of one training step on B x S tokens: 6 N_active T plus
    causal attention's two forward products (each 2 B H S^2 hd, halved by
    causality) times 3 for the forward and backward."""
    return (6.0 * active_params(m) * B * S
            + 6.0 * m.n_layers * B * m.n_heads * S * S * m.head_dim)


def expert_gemm_work(m: MoESpec, copies: float) -> tuple:
    """(FLOPs, bytes) of the expert GEMMs of one step over ``copies``
    routed token copies a layer: 3 forward and 6 backward products of
    2 d d_ff each; bytes: the bf16 weights read in the forward and the
    backward, their f32 gradients written, each copy's bf16 input read and
    output written, its f32 output gradient read and input gradient
    written."""
    d, f, E = m.d_model, m.d_ff, m.n_experts
    flops = m.n_layers * copies * 9 * 2.0 * d * f
    w = 3 * E * d * f
    nbytes = m.n_layers * (2 * w * 2 + w * 4 + copies * d * (2 + 2 + 4 + 4))
    return flops, nbytes


def flash_work(m: MoESpec, B: int, S: int) -> tuple:
    """(FLOPs, bytes) of causal flash attention in one step: 2 forward and
    4 backward products of 2 B H S^2 hd each, halved by causality; q, o,
    do, dq (H heads), k, v, dk, dv (KH heads) in bf16 and the f32
    log-sum-exp, each once."""
    H, KH, hd = m.n_heads, m.n_kv_heads, m.head_dim
    flops = m.n_layers * 6 * (2.0 * B * H * S * S * hd) / 2
    nbytes = m.n_layers * (B * S * hd * 2 * (4 * H + 4 * KH) + B * H * S * 4)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of its two
    bounds."""
    return max(flops / H100_PEAK_BF16, nbytes / H100_HBM_BW)
