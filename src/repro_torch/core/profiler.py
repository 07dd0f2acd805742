"""Analytical profiler — stands in for the paper's §5 measurement profiler.

Produces the quantities Algorithm 1 and the simulator consume:

    T_A^Attn : one layer's attention block (incl. QKV/O projections, gate)
               for one microbatch, on an attention-GPU class.
    T_E^Exp  : one layer's expert compute for one microbatch on one expert
               GPU (depends on the tokens it receives, not which experts).
    T_E^Attn : a single expert FFN with the same per-GPU batch on an
               attention-GPU class.
    memory   : per-expert and attention-side memory -> n_min / n_max.

Timing model per module: max(FLOP term, HBM-traffic term) with per-class
efficiency constants (hardware.py). Backward = 2x forward (paper §4.2: the
assignment optimized on forward times reduces both).

A copy of the JAX package's ``core/profiler.py`` with its imports rewritten
to the port (it imports neither jax nor the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.hardware import DeviceClass
from repro_torch.models.config import ModelConfig

BYTES = 2  # bf16/fp16 compute per the paper's mixed-precision setup


@dataclasses.dataclass(frozen=True)
class LayerTimes:
    """Per-microbatch forward times (seconds) for one layer.

    Follows the paper's §5 profiler semantics: T_E^Attn is ONE expert FFN
    over the full per-expert-GPU token batch B on an attention GPU (one
    expert's actual share is then T_E^Attn * N / n).

    Overlap-aware extension (DESIGN.md §8): t_dispatch / t_combine carry
    the per-microbatch all-to-all wire times (zero when no link bandwidth
    was supplied), so consumers can price the EXPOSED residue of chunked,
    double-buffered dispatch (simulator.exposed_comm) instead of the full
    serialized transfer.
    """

    t_attn: float       # T_A^Attn on the attention class
    t_exp: float        # T_E^Exp on the expert class (its full token load)
    t_exp_attn: float   # T_E^Attn on the attention class (full B tokens)
    t_exp_on_exp: float      # one expert FFN, full B tokens, expert class
    t_attn_on_exp: float     # attention block on the expert class (EP baseline)
    t_dispatch: float = 0.0  # dispatch all-to-all wire time, one direction
    t_combine: float = 0.0   # combine all-to-all wire time, one direction


def gemm_time(flops: float, bytes_moved: float, dev: DeviceClass) -> float:
    return max(flops / (dev.peak_flops * dev.gemm_eff),
               bytes_moved / dev.hbm_bw)


def attention_core_time(flops: float, bytes_moved: float,
                        dev: DeviceClass) -> float:
    if dev.has_flash_attention:
        return flops / (dev.peak_flops * dev.attn_eff)
    # Unfused attention: low achieved compute efficiency AND S-matrix HBM
    # traffic — whichever binds.
    return max(flops / (dev.peak_flops * dev.attn_eff_nofa),
               bytes_moved / dev.hbm_bw)


def attention_block_time(cfg: ModelConfig, tokens_per_gpu: int, seq_len: int,
                         dev: DeviceClass) -> float:
    """One layer's attention block (projections + SDPA + router) forward."""
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_seq = max(tokens_per_gpu // seq_len, 1)
    proj_flops = 2 * tokens_per_gpu * d * (2 * h * hd + 2 * kh * hd)
    proj_bytes = BYTES * d * (2 * h * hd + 2 * kh * hd)
    t = gemm_time(proj_flops, proj_bytes, dev)
    # SDPA core: 2 matmuls, causal halves the work.
    causal_frac = 0.5 if cfg.causal else 1.0
    core_flops = 2 * 2 * n_seq * seq_len * seq_len * h * hd * causal_frac
    # Unfused: S materialized in HBM ~4 passes (write S, read S, write P,
    # read P), fp16.
    core_bytes = 4 * n_seq * h * seq_len * seq_len * BYTES * causal_frac
    t += attention_core_time(core_flops, core_bytes, dev)
    if cfg.is_moe:  # router
        t += gemm_time(2 * tokens_per_gpu * d * cfg.n_experts,
                       BYTES * d * cfg.n_experts, dev)
    return t


def expert_ffn_time(cfg: ModelConfig, tokens: int, dev: DeviceClass) -> float:
    """One expert FFN over `tokens` tokens, forward."""
    d, f = cfg.d_model, cfg.d_ff_expert
    n_mats = 3 if cfg.mlp_act == "swiglu" else 2
    flops = 2 * tokens * d * f * n_mats
    byts = BYTES * d * f * n_mats
    return gemm_time(flops, byts, dev)


def mixer_nonattn_time(cfg: ModelConfig, tokens: int, dev: DeviceClass) -> float:
    """SSD / RG-LRU mixers (for completeness in non-MoE archs)."""
    d = cfg.d_model
    if cfg.ssm_state:
        din = cfg.ssm_expand * d
        flops = 2 * tokens * d * (2 * din + 2 * cfg.ssm_state) \
            + 2 * tokens * din * d \
            + 2 * tokens * cfg.ssm_chunk * (din + 2 * cfg.ssm_state)
        return gemm_time(flops, BYTES * 3 * d * din, dev)
    w = cfg.lru_width
    flops = 2 * tokens * (2 * d * w + 2 * w * w + w * d)
    return gemm_time(flops, BYTES * (2 * d * w + 2 * w * w + w * d), dev)


@dataclasses.dataclass(frozen=True)
class ZPGroupShape:
    """A zebra-parallelism group: M attention devices + N expert devices."""

    M: int
    N: int
    attn_class: DeviceClass
    exp_class: DeviceClass


def a2a_time(cfg: ModelConfig, mb_tokens: int, link_bw: float, M: int,
             N: int) -> float:
    """One-direction all-to-all wire time for one microbatch: every routed
    token copy crosses the bipartite cut once per direction (paper: no
    extra communication vs EP)."""
    byts = mb_tokens * max(cfg.top_k, 1) * cfg.d_model * BYTES
    agg_bw = link_bw * min(M, N) if min(M, N) else link_bw
    return byts / agg_bw


def profile_layer(cfg: ModelConfig, zp: ZPGroupShape, global_batch: int,
                  seq_len: int, num_microbatches: int,
                  link_bw: Optional[float] = None) -> LayerTimes:
    """The paper-profiler quantities for one (model, ZP group, batch).

    With ``link_bw`` the returned LayerTimes also carries the dispatch /
    combine all-to-all wire times (the overlap-aware fields)."""
    mb_tokens = global_batch * seq_len // num_microbatches
    tokens_per_attn_gpu = mb_tokens // zp.M
    # Each expert GPU receives (top_k-weighted) token copies for its experts.
    copies = mb_tokens * max(cfg.top_k, 1)
    tokens_per_exp_gpu = copies // max(zp.N, 1)

    t_attn = attention_block_time(cfg, tokens_per_attn_gpu,
                                  seq_len, zp.attn_class)
    t_exp = expert_ffn_time(cfg, tokens_per_exp_gpu, zp.exp_class)
    t_exp_attn = expert_ffn_time(cfg, tokens_per_exp_gpu, zp.attn_class)
    t_exp_on_exp = expert_ffn_time(cfg, tokens_per_exp_gpu, zp.exp_class)
    t_attn_on_exp = attention_block_time(cfg, tokens_per_attn_gpu, seq_len,
                                         zp.exp_class)
    t_a2a = a2a_time(cfg, mb_tokens, link_bw, zp.M, zp.N) if link_bw else 0.0
    return LayerTimes(t_attn=t_attn, t_exp=t_exp, t_exp_attn=t_exp_attn,
                      t_exp_on_exp=t_exp_on_exp,
                      t_attn_on_exp=t_attn_on_exp,
                      t_dispatch=t_a2a, t_combine=t_a2a)


# ---------------------------------------------------------------------------
# Serving-mode profile (DESIGN.md §10)
# ---------------------------------------------------------------------------
#
# The serving analogue of LayerTimes: the two quantities the disaggregation
# planner trades off are t_prefill_chunk (a chunked-prefill slice — the
# attention-heavy, compute-bound task the NEWER class dominates, exactly
# the Fig. 2 attention gap) and t_decode_step (one batched decode step —
# KV reads + expert/FFN weight reads, memory-bound, where the older class
# stays efficient). Both are profiled per device class so plan_disagg_group
# can sweep role splits the same way Asym-EA sweeps expert offload.

@dataclasses.dataclass(frozen=True)
class ServeProfile:
    """Per-class serving step times (seconds) + the KV handoff wire time."""

    t_prefill_chunk_attn: float  # one chunk slice on the attention class
    t_prefill_chunk_exp: float   # ... on the expert class
    t_decode_step_attn: float    # one batched decode step on the attn class
    t_decode_step_exp: float     # ... on the expert class
    t_page: float                # one KV page across the inter-group link
    chunk: int                   # prefill chunk the times were profiled at
    decode_batch: int            # decode batch the step times assume


def serve_ffn_time(cfg: ModelConfig, tokens: int, dev: DeviceClass) -> float:
    """Whole-FFN time at serving batch sizes. Small-M MoE decode is weight-
    read bound (the group-dense regime, DESIGN.md §5.5): HBM traffic covers
    every ACTIVATED expert's weights, not one expert's."""
    d = cfg.d_model
    n_mats = 3 if cfg.mlp_act == "swiglu" else 2
    if cfg.is_moe:
        f = cfg.d_ff_expert
        copies = tokens * max(cfg.top_k, 1)
        n_act = min(cfg.n_experts, max(copies, 1))
        return gemm_time(2 * copies * d * f * n_mats,
                         BYTES * n_act * d * f * n_mats, dev)
    return gemm_time(2 * tokens * d * cfg.d_ff * n_mats,
                     BYTES * d * cfg.d_ff * n_mats, dev)


def prefill_chunk_time(cfg: ModelConfig, chunk: int, ctx: int,
                       dev: DeviceClass) -> float:
    """One whole-stack chunked-prefill slice: ``chunk`` new tokens
    attending over a ``ctx``-line cache. Compute-bound: the SDPA core is
    chunk x ctx and runs at the class's (un)fused attention efficiency —
    this is where the generation gap bites (Fig. 2a)."""
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj_flops = 2 * chunk * d * (2 * h * hd + 2 * kh * hd)
    proj_bytes = BYTES * d * (2 * h * hd + 2 * kh * hd)
    t = gemm_time(proj_flops, proj_bytes, dev)
    core_flops = 2 * 2 * chunk * ctx * h * hd
    core_bytes = 4 * h * chunk * ctx * BYTES
    t += attention_core_time(core_flops, core_bytes, dev)
    if cfg.is_moe:
        t += gemm_time(2 * chunk * d * cfg.n_experts,
                       BYTES * d * cfg.n_experts, dev)
    t += serve_ffn_time(cfg, chunk, dev)
    return cfg.n_layers * t


def decode_step_time(cfg: ModelConfig, batch: int, ctx: int,
                     dev: DeviceClass) -> float:
    """One batched decode step (1 token per slot) at context ``ctx``:
    KV-cache reads + FFN weight reads dominate, so the roofline's HBM leg
    binds on both classes — the old generation loses little here."""
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj_flops = 2 * batch * d * (2 * h * hd + 2 * kh * hd)
    proj_bytes = BYTES * d * (2 * h * hd + 2 * kh * hd)
    t = gemm_time(proj_flops, proj_bytes, dev)
    core_flops = 2 * 2 * batch * ctx * h * hd
    kv_bytes = batch * ctx * 2 * kh * hd * BYTES  # the whole cache, once
    eff = dev.attn_eff if dev.has_flash_attention else dev.attn_eff_nofa
    t += max(core_flops / (dev.peak_flops * eff), kv_bytes / dev.hbm_bw)
    if cfg.is_moe:
        t += gemm_time(2 * batch * d * cfg.n_experts,
                       BYTES * d * cfg.n_experts, dev)
    t += serve_ffn_time(cfg, batch, dev)
    t = cfg.n_layers * t
    # Unembedding head (decode samples every step; prefill only at the end,
    # where it is amortized over the whole prompt and left out).
    t += gemm_time(2 * batch * d * cfg.vocab_size,
                   BYTES * d * cfg.vocab_size, dev)
    return t


def ep_decode_step_time(cfg: ModelConfig, batch: int, ctx: int,
                        placement, shard_classes, hist, *,
                        n_chunks: int = 1,
                        link_bw: Optional[float] = None) -> float:
    """One EP-sharded batched decode step (DESIGN.md §11).

    The attention / router / head legs run replicated, so the slowest
    class present paces them. The expert hop is the max over shards of
    each shard's time for ITS experts under the observed routing
    distribution ``hist``: expected token copies give the FLOP leg and
    expected ACTIVATED experts give the weight-read leg — decode is
    weight-read bound (serve_ffn_time's regime), and a hot expert is read
    every step while a cold one is rarely touched, which is the lever
    heterogeneity-aware placement pulls (hot -> high-HBM-bandwidth class).
    With ``link_bw`` the dispatch+combine all-to-alls price only their
    EXPOSED residue after ``n_chunks`` double-buffered capacity chunks
    (simulator.exposed_comm), mirroring the zebra training cost model.
    """
    from repro_torch.core.simulator import exposed_comm  # lazy: avoid cycle
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k = max(cfg.top_k, 1)
    n_mats = 3 if cfg.mlp_act == "swiglu" else 2
    f = cfg.d_ff_expert
    tot = sum(hist) or 1.0
    p = [x / tot for x in hist]
    # P(expert activated by >= 1 of the batch*k routed copies).
    a = [1.0 - (1.0 - pe) ** (batch * k) for pe in p]

    def attn_leg(dev):
        proj_flops = 2 * batch * d * (2 * h * hd + 2 * kh * hd)
        proj_bytes = BYTES * d * (2 * h * hd + 2 * kh * hd)
        t = gemm_time(proj_flops, proj_bytes, dev)
        core_flops = 2 * 2 * batch * ctx * h * hd
        kv_bytes = batch * ctx * 2 * kh * hd * BYTES
        eff = dev.attn_eff if dev.has_flash_attention else dev.attn_eff_nofa
        t += max(core_flops / (dev.peak_flops * eff), kv_bytes / dev.hbm_bw)
        t += gemm_time(2 * batch * d * cfg.n_experts,
                       BYTES * d * cfg.n_experts, dev)
        return t

    t_attn = max(attn_leg(c) for c in shard_classes)
    t_exp = 0.0
    for experts, dev in zip(placement, shard_classes):
        copies = sum(p[e] for e in experts) * batch * k
        n_act = sum(a[e] for e in experts)
        t_exp = max(t_exp, gemm_time(2 * copies * d * f * n_mats,
                                     BYTES * n_act * d * f * n_mats, dev))
    t_comm = 0.0
    if link_bw:
        ep_size = max(len(placement), 1)
        t_wire = a2a_time(cfg, batch, link_bw, ep_size, ep_size)
        t_comm = 2 * exposed_comm(t_wire, t_exp, n_chunks)
    t = cfg.n_layers * (t_attn + t_exp + t_comm)
    t += max(gemm_time(2 * batch * d * cfg.vocab_size,
                       BYTES * d * cfg.vocab_size, c)
             for c in shard_classes)
    return t


def expert_param_bytes(cfg: ModelConfig) -> int:
    """Expert weight residency (wi_gate+wi_up+wo, every layer, bf16) —
    what replicated serving charges EVERY decode device and EP sharding
    divides by ep_size (assumes every layer is MoE, like the serve-mode
    step-time models above)."""
    n_mats = 3 if cfg.mlp_act == "swiglu" else 2
    return cfg.n_layers * cfg.n_experts * n_mats * cfg.d_model \
        * cfg.d_ff_expert * BYTES


def kv_page_bytes(cfg: ModelConfig, page_size: int) -> int:
    """Payload bytes of one physical KV page across every attention
    layer's pools (k + v in bf16 plus the int32 position pool) — what one
    page costs on the handoff link."""
    per_layer = 2 * page_size * cfg.n_kv_heads * cfg.head_dim * BYTES \
        + page_size * 4
    return cfg.n_layers * per_layer


def serve_profile(cfg: ModelConfig, attn_class: DeviceClass,
                  exp_class: DeviceClass, *, chunk: int, ctx: int,
                  decode_batch: int, page_size: int = 16,
                  link_bw: Optional[float] = None) -> ServeProfile:
    """Profile both classes for both serving roles (the planner needs the
    off-role times too: a unified deployment runs BOTH phases on the
    slower class's clock)."""
    bw = link_bw if link_bw else min(attn_class.link_bw, exp_class.link_bw)
    return ServeProfile(
        t_prefill_chunk_attn=prefill_chunk_time(cfg, chunk, ctx, attn_class),
        t_prefill_chunk_exp=prefill_chunk_time(cfg, chunk, ctx, exp_class),
        t_decode_step_attn=decode_step_time(cfg, decode_batch, ctx,
                                            attn_class),
        t_decode_step_exp=decode_step_time(cfg, decode_batch, ctx,
                                           exp_class),
        t_page=kv_page_bytes(cfg, page_size) / bw,
        chunk=chunk, decode_batch=decode_batch)


# ---------------------------------------------------------------------------
# Memory estimation -> n_min / n_max for Asym-EA
# ---------------------------------------------------------------------------

def expert_memory_bytes(cfg: ModelConfig, tokens_per_expert: int) -> float:
    """Weights + grads + Adam states + activations for ONE expert FFN."""
    n_mats = 3 if cfg.mlp_act == "swiglu" else 2
    w = n_mats * cfg.d_model * cfg.d_ff_expert
    weight_grad_opt = w * (BYTES + BYTES + 8)  # bf16 w, bf16 g, f32 m+v
    acts = tokens_per_expert * cfg.d_ff_expert * BYTES * 2  # ckpt boundary
    return weight_grad_opt + acts


def attention_side_memory_bytes(cfg: ModelConfig, tokens_per_gpu: int) -> float:
    """Non-expert params + states + activations per attention GPU."""
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = d * (2 * h * hd + 2 * kh * hd) + 2 * d
    if cfg.is_moe:
        per_layer += d * cfg.n_experts
    w = per_layer * cfg.n_layers + 2 * cfg.vocab_size * d
    weight_grad_opt = w * (BYTES + BYTES + 8)
    # activation checkpointing: one activation per layer boundary + working set
    acts = cfg.n_layers * tokens_per_gpu * d * BYTES \
        + 6 * tokens_per_gpu * d * BYTES
    return weight_grad_opt + acts


def asym_ea_memory_bounds(cfg: ModelConfig, zp: ZPGroupShape,
                          global_batch: int, seq_len: int,
                          num_microbatches: int):
    """(n_min, n_max): total experts that MUST / CAN move to attention GPUs.

    n_min: experts that do not fit on the N expert GPUs (summed over layers).
    n_max: spare capacity per attention GPU in expert units.
    """
    mb_tokens = global_batch * seq_len // num_microbatches
    tokens_per_expert = mb_tokens * max(cfg.top_k, 1) // max(cfg.n_experts, 1)
    e_mem = expert_memory_bytes(cfg, tokens_per_expert)
    total_expert_mem = cfg.n_layers * cfg.n_experts * e_mem
    exp_capacity = zp.N * zp.exp_class.mem_bytes * 0.9
    n_min = max(0, math.ceil((total_expert_mem - exp_capacity) / e_mem))

    a_mem = attention_side_memory_bytes(cfg, mb_tokens // zp.M)
    spare = zp.attn_class.mem_bytes * 0.9 - a_mem
    n_max_per_gpu = max(0, int(spare // e_mem))
    return n_min, n_max_per_gpu * zp.M
