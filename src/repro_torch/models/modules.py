"""Neural-net modules of the serving and training main paths (mirror of
``repro/models/modules.py``): norms, RoPE, embeddings, GQA attention
(cache-free reference, chunked and flash, and paged), the dense and MoE
FFNs, and the layer glue.

Each module is an (init, apply) pair. ``init_*`` returns a tree of
:class:`repro_torch.pytree.ParamSpec` (shape + initializer) that
``stack.init_model`` materializes; ``apply_*`` are plain functions over
tensor trees. Params are f32 and every matrix is cast to the compute dtype
where it is used (``.to(cd)``), as in the JAX package; a caller may hand in
a tree that already holds those matrices in the compute dtype
(``stack.compute_params``), which makes the casts no-ops with identical
values.

Ported: attention mixers (full and sliding-window; reference, chunked and
flash attention), the mamba2 SSD mixer (its cache-free path through the SSD
scan kernel, its cached path through ``ref.ssd_decode_step``) and dense /
MoE FFNs. The RG-LRU mixer and cross-attention are later slices; their init
raises. The engines' decode states hold attention caches only: a model with
an SSD layer trains, and ``init_layer_state`` refuses it.

Training runs these functions under autograd. The in-place writes on the
cache-free path are autograd-safe: ``apply_moe``'s combine ``index_add_``
writes into a fresh zero tensor that no backward reads, and the paged KV
update, which writes into the serving pool in place, runs only with a
cache, never in training.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.pytree import ParamSpec

_BIG_NEG = -0.7 * torch.finfo(torch.float32).max


# ---------------------------------------------------------------------------
# Runtime policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    accum_dtype: Any = torch.float32  # norms / softmax / router / logits


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime knobs orthogonal to the architecture.

    attn_impl: "ref" (default; the materialized reference), "chunked"
    (query chunks with recomputed scores, what the train driver runs) or
    "flash" (the flash attention kernels and their backward, for
    structural masks). moe_impl: "gather" (default) is the single-pack
    ``ops.moe_ffn`` pipeline every serve and train path runs; "dense" is
    the every-token-through-every-expert einsum, kept only as the exact
    test reference. remat: "none", "full" (each layer recomputed in the
    backward) or "dots" (each layer recomputed but for the outputs of its
    matrix products without batch dims, which are saved:
    :func:`dots_with_no_batch_dims_saveable`). There is no kernel switch:
    the kernel wrappers launch their CUDA kernels for CUDA tensors and run
    their plain versions for CPU tensors."""

    policy: Policy = Policy()
    attn_impl: str = "ref"
    moe_impl: str = "gather"
    remat: str = "none"
    chunk_q: int = 512  # query-chunk size of the chunked attention path

    def __post_init__(self):
        if self.attn_impl not in ("ref", "chunked", "flash"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat {self.remat!r}")
        if self.moe_impl not in ("gather", "dense"):
            raise ValueError(f"unknown moe_impl {self.moe_impl!r}")


def dots_with_no_batch_dims_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``, the counterpart of
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` (the JAX
    package's stack.py:158-163): the output of a matrix product without
    batch dims is saved, every other op is recomputed in the backward.

    It decides by the aten op and its batch extent, not by the op's name
    alone: ``x @ w`` on a [B, S, d] activation reaches ``aten.mm`` after a
    reshape, and ``torch.einsum`` lowers a contraction without batch dims
    (``"td,edf->tef"``) to ``aten.bmm`` with batch 1; so ``mm``/``addmm``
    and ``bmm``/``baddbmm`` of batch 1 are saved, and a ``bmm`` over a
    real batch (the attention scores, the per-token combine) is not. The
    hand-written kernels launch through ctypes inside ``ops._MoEFFN`` and
    ``_FlashAttention`` and are no aten ops, so their products are
    recomputed, as a ``pallas_call`` is under the JAX policy (on the CPU
    their plain versions are batched ``bmm``s over m-tiles: recomputed
    too). Remat changes what is stored, not what is computed: a step under
    "dots" gives the bits of one under "full"."""
    packet = getattr(op, "overloadpacket", None)
    aten = torch.ops.aten
    if packet in (aten.mm, aten.addmm):
        return CheckpointPolicy.MUST_SAVE
    if packet is aten.bmm and args[0].shape[0] == 1:
        return CheckpointPolicy.MUST_SAVE
    if packet is aten.baddbmm and args[1].shape[0] == 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def dots_context():
    """``context_fn`` of a ``remat="dots"`` checkpoint (the policy is read
    at each call)."""
    return create_selective_checkpoint_contexts(
        dots_with_no_batch_dims_saveable)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, dim: int | None = None):
    dim = dim or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((dim,), "ones"),
                "bias": ParamSpec((dim,), "zeros")}
    return {"scale": ParamSpec((dim,), "ones")}


def apply_norm(params, x, policy: Policy, eps: float = 1e-6):
    acc = policy.accum_dtype
    xf = x.to(acc)
    if "bias" in params:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].to(acc) + params["bias"].to(acc)
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
        y = y * params["scale"].to(acc)
    return y.to(policy.compute_dtype)


def rms_norm_headwise(scale, x, policy: Policy, eps: float = 1e-6):
    """Per-head RMSNorm over the trailing head_dim (qk_norm)."""
    acc = policy.accum_dtype
    xf = x.to(acc)
    ms = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * scale.to(acc)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def apply_rope(x, positions, theta: float):
    """x: [..., S, n_heads, head_dim]; positions: [..., S] int."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[..., None] * freqs  # [..., S, half]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def init_embedding(cfg: ModelConfig):
    if cfg.learned_pos:
        raise NotImplementedError("learned positions (whisper) are not "
                                  "ported yet")
    return {"table": ParamSpec((cfg.vocab_size, cfg.d_model),
                               fan_in=cfg.d_model)}


def apply_embedding(params, cfg: ModelConfig, policy: Policy, tokens):
    cd = policy.compute_dtype
    x = params["table"][tokens.long()].to(cd)
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd,
                             device=x.device)
    return x


def apply_unembedding(params, head, cfg: ModelConfig, policy: Policy, x):
    """x: [..., d_model] -> logits [..., vocab] in the accum dtype.

    The JAX package multiplies compute-dtype operands with an unrounded f32
    result; here both operands are widened to f32 first, which gives the
    same exact products (a bf16 matmul would round the logits and create
    argmax ties)."""
    table = head if head is not None else params["table"]
    acc = policy.accum_dtype
    return x.to(acc) @ table.to(policy.compute_dtype).to(acc).T


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig):
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params = {
        "wq": ParamSpec((d, h * hd), fan_in=d),
        "wk": ParamSpec((d, kh * hd), fan_in=d),
        "wv": ParamSpec((d, kh * hd), fan_in=d),
        "wo": ParamSpec((h * hd, d), fan_in=h * hd),
    }
    if cfg.qk_norm:
        params["q_norm"] = ParamSpec((hd,), "ones")
        params["k_norm"] = ParamSpec((hd,), "ones")
    return params


def attention_mask(q_pos, kv_pos, causal: bool, window: int):
    """Boolean mask [..., S_q, S_kv]: True = attend."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    mask = k >= 0  # entries with negative positions = unwritten cache lines
    if causal:
        mask = mask & (k <= q)
    if window > 0:
        mask = mask & ((q - k) < window)
    return mask


def ref_attention(q, k, v, mask, scale: float, softcap: float,
                  policy: Policy):
    """GQA attention oracle. q: [B,S,H,hd], k/v: [B,T,KH,hd],
    mask [B,S,T] | [S,T]. Logits and softmax in f32 (the JAX package's
    preferred_element_type=f32), probabilities cast to the compute dtype
    for the value product."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    qf = q.reshape(B, S, KH, H // KH, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qf.float(), k.float()) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    if mask.dim() == 2:
        mask = mask[None]
    logits = torch.where(mask[:, None, None, :, :], logits, _BIG_NEG)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(policy.compute_dtype), v)
    return out.reshape(B, S, H, hd)


def chunked_attention(q, k, v, q_pos, kv_pos, *, causal: bool, window: int,
                      scale: float, softcap: float, policy: Policy,
                      chunk_q: int = 512):
    """Flash-equivalent attention in plain torch: a loop over query chunks,
    per-chunk structural masking, each chunk checkpointed so the backward
    recomputes its scores (the JAX package's ``jax.checkpoint`` per chunk).
    Never materializes the full [S, T] score matrix or mask.

    q: [B,S,H,hd]; k/v: [B,T,KH,hd]; q_pos: [B,S]; kv_pos: [B,T]. Logits
    and softmax in f32, probabilities cast to the compute dtype for the
    value product, as :func:`ref_attention`."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    cq = min(chunk_q, S)
    pad = (-S) % cq
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=-1)
    nq = (S + pad) // cq

    def block(qb, qp, kb, vb, kvp):
        qf = qb.reshape(B, cq, KH, G, hd)
        logits = torch.einsum("bskgh,btkh->bkgst", qf.float(),
                              kb.float()) * scale
        if softcap > 0:
            logits = softcap * torch.tanh(logits / softcap)
        m = attention_mask(qp, kvp, causal, window)
        m = m & (qp[..., :, None] >= 0)
        logits = torch.where(m[:, None, None, :, :], logits, _BIG_NEG)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgst,btkh->bskgh",
                           probs.to(policy.compute_dtype), vb)
        return out.reshape(B, cq, H, hd)

    outs = [checkpoint(block, q[:, i * cq:(i + 1) * cq],
                       q_pos[:, i * cq:(i + 1) * cq], k, v, kv_pos,
                       use_reentrant=False)
            for i in range(nq)]
    o = outs[0] if nq == 1 else torch.cat(outs, dim=1)
    return o[:, :S]


def _attention_inner(q, k, v, cfg: ModelConfig, run: RunConfig, *,
                     positions, kv_pos, causal: bool, window: int,
                     structural: bool):
    """Dispatch to the flash kernels / chunked / materialized reference
    attention. Flash and chunked apply to structural masks only (the
    cache-free path, positions 0..S-1); flash masks from those positions
    itself and is not handed them."""
    scale = cfg.head_dim ** -0.5
    softcap = cfg.attn_logit_softcap
    if structural and run.attn_impl == "flash":
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    scale=scale, softcap=softcap)
    if structural and run.attn_impl == "chunked":
        return chunked_attention(q, k, v, positions, kv_pos, causal=causal,
                                 window=window, scale=scale, softcap=softcap,
                                 policy=run.policy, chunk_q=run.chunk_q)
    mask = attention_mask(positions, kv_pos, causal=causal, window=window)
    return ref_attention(q, k, v, mask, scale, softcap, run.policy)


def _project_qkv(params, cfg: ModelConfig, run: RunConfig, x, positions,
                 rope: bool = True):
    """q/k/v projection + qk-norm + rope. Returns (q, k, v, kv_pos)."""
    B, S, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pol = run.policy
    cd = pol.compute_dtype
    q = (x @ params["wq"].to(cd)).reshape(B, S, h, hd)
    k = (x @ params["wk"].to(cd)).reshape(B, S, kh, hd)
    v = (x @ params["wv"].to(cd)).reshape(B, S, kh, hd)
    if "q_norm" in params:
        q = rms_norm_headwise(params["q_norm"], q, pol)
        k = rms_norm_headwise(params["k_norm"], k, pol)
    if rope and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, positions


def _apply_attention_paged(params, cfg: ModelConfig, run: RunConfig, x,
                           positions, *, causal: bool, window: int, cache,
                           cache_index, rope: bool, page_table):
    """Paged-cache attention (DESIGN.md §9): scatter this step's K/V through
    the page table into the shared pool, then attend over the slot's pages.

    cache: k/v [P, ps, KH, hd] + pos [P, ps] — the POOL, no batch dim. The
    pool is updated IN PLACE (the JAX package returns a new pool); the
    returned cache is the same dict. Vector ``cache_index`` = per-slot
    decode (S == 1); scalar = chunked prefill at batch 1 writing lines
    [offset, offset + S). Dead slots (index < 0) and unallocated table
    slots write nothing: their rows are masked out of the scatter (the JAX
    package routes them to an out-of-bounds sentinel and drops them). Key
    positions are structural, never read back from the pool.
    """
    B, S, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    cd = run.policy.compute_dtype
    q, k, v, _ = _project_qkv(params, cfg, run, x, positions, rope=rope)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    ps = ck.shape[1]
    MP = page_table.shape[1]
    ci = torch.as_tensor(cache_index, device=x.device)
    if ci.dim() == 1:
        # Per-slot decode: row b writes line cache_index[b] of its own run.
        p = ci.long()
        pslot = (p.clamp(min=0) // ps).clamp(max=MP - 1)
        page = page_table.long().gather(1, pslot[:, None])[:, 0]
        keep = (p >= 0) & (page >= 0)
        page, line = page[keep], (p % ps)[keep]
        ck[page, line] = k[:, 0][keep].to(ck.dtype)
        cv[page, line] = v[:, 0][keep].to(cv.dtype)
        cpos[page, line] = positions[:, 0][keep].to(cpos.dtype)
    else:
        # Chunked prefill at batch 1: per-position scatter through the
        # single request's table (pages need not be contiguous).
        lines = ci.long() + torch.arange(S, device=x.device)
        pslot = (lines // ps).clamp(max=MP - 1)
        page = page_table[0].long()[pslot]
        keep = page >= 0
        page, line = page[keep], (lines % ps)[keep]
        ck[page, line] = k[0][keep].to(ck.dtype)
        cv[page, line] = v[0][keep].to(cv.dtype)
        cpos[page, line] = positions[0][keep].to(cpos.dtype)

    scale = hd ** -0.5
    softcap = cfg.attn_logit_softcap
    if S == 1 and causal:
        # Block-gathered flash decode over the pool: the CUDA kernel on the
        # card, its plain version on the CPU.
        out = kops.paged_decode_attention(
            q[:, 0], ck, cv, page_table, positions[:, 0].to(torch.int32),
            scale=scale, softcap=softcap, window=window)[:, None]
    else:
        kg, vg, kv_pos = kops.paged_gather_kv(ck, cv, page_table)
        out = _attention_inner(q, kg, vg, cfg, run, positions=positions,
                               kv_pos=kv_pos, causal=causal, window=window,
                               structural=False)
    y = out.reshape(B, S, h * hd) @ params["wo"].to(cd)
    return y, cache


def apply_attention(params, cfg: ModelConfig, run: RunConfig, x, positions,
                    *, causal: bool, window: int = 0, cache=None,
                    cache_index=None, rope: bool = True, page_table=None):
    """Full / sliding-window self-attention, cache-free or paged.

    x: [B, S, d]; positions: [B, S]. Without a cache, attention runs over
    the fresh K/V with the structural mask. With ``page_table`` [B, MP],
    ``cache`` holds the shared physical pool and row b's cache line p
    lives at line p % ps of page page_table[b, p // ps] (see
    :func:`_apply_attention_paged`). Dense per-slot caches are not ported.
    """
    if cache is not None:
        if page_table is None:
            raise NotImplementedError("dense KV caches are not ported; "
                                      "serve with the paged cache")
        return _apply_attention_paged(
            params, cfg, run, x, positions, causal=causal, window=window,
            cache=cache, cache_index=cache_index, rope=rope,
            page_table=page_table)
    B, S, _ = x.shape
    cd = run.policy.compute_dtype
    q, k, v, kv_pos = _project_qkv(params, cfg, run, x, positions, rope)
    out = _attention_inner(q, k, v, cfg, run, positions=positions,
                           kv_pos=kv_pos, causal=causal, window=window,
                           structural=True)
    y = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ params["wo"].to(cd)
    return y, None


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                         window: int, dtype, device="cpu"):
    C = min(window, max_len) if window > 0 else max_len
    shape = (batch, C, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, C), -1, dtype=torch.int32, device=device),
    }


def init_paged_attention_cache(cfg: ModelConfig, n_pages: int,
                               page_size: int, dtype, device="cpu"):
    """Shared physical KV pool for ONE attention layer (DESIGN.md §9): no
    batch dim — slots own disjoint page subsets through their page tables.
    Sliding-window layers share the layout (window enforced by masking)."""
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((n_pages, page_size), -1, dtype=torch.int32,
                          device=device),
    }


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"wi_gate": ParamSpec((d, f), fan_in=d),
                "wi_up": ParamSpec((d, f), fan_in=d),
                "wo": ParamSpec((f, d), fan_in=f)}
    return {"wi": ParamSpec((d, f), fan_in=d),  # gelu (whisper)
            "bi": ParamSpec((f,), "zeros"),
            "wo": ParamSpec((f, d), fan_in=f),
            "bo": ParamSpec((d,), "zeros")}


def apply_mlp(params, cfg: ModelConfig, run: RunConfig, x):
    cd = run.policy.compute_dtype
    if "wi_gate" in params:
        g = F.silu(x @ params["wi_gate"].to(cd))
        u = x @ params["wi_up"].to(cd)
        return (g * u) @ params["wo"].to(cd)
    h = F.gelu(x @ params["wi"].to(cd) + params["bi"].to(cd),
               approximate="tanh")
    return h @ params["wo"].to(cd) + params["bo"].to(cd)


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    return {
        "router": ParamSpec((d, e), fan_in=d),
        "wi_gate": ParamSpec((e, d, f), fan_in=d),
        "wi_up": ParamSpec((e, d, f), fan_in=d),
        "wo": ParamSpec((e, f, d), fan_in=f),
    }


def _bincount(x, length: int):
    """``jnp.bincount(x, length=length)`` as a scatter-add: same counts as
    ``torch.bincount(x, minlength=length)`` for x < length, without the
    host sync bincount takes on CUDA to size its output."""
    return torch.zeros(length, dtype=torch.int64, device=x.device) \
        .index_add_(0, x.long(), torch.ones_like(x, dtype=torch.int64))


def moe_route(router_w, cfg: ModelConfig, policy: Policy, x2d):
    """Router in f32: returns (weights [T,k], idx [T,k] int32, aux dict)."""
    acc = policy.accum_dtype
    logits = x2d.to(acc) @ router_w.to(acc)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True)
    # Switch-style load-balance loss + router z-loss (training signals,
    # kept so the router's outputs match the JAX package's one for one).
    T = x2d.shape[0]
    counts = _bincount(idx.reshape(-1), cfg.n_experts)
    f = counts.to(acc) / (T * cfg.top_k)
    p = probs.mean(0)
    aux = {
        "moe_aux_loss": cfg.n_experts * (f * p).sum() * cfg.router_aux_coef,
        "moe_z_loss": torch.logsumexp(logits, -1).square().mean()
        * cfg.router_z_coef,
    }
    return weights, idx.to(torch.int32), aux


def expert_ffn(wi_gate, wi_up, wo, xs, group_sizes, run: RunConfig,
               row_scales=None):
    """Grouped expert FFN over expert-sorted tokens xs [Tk, d] through the
    single-pack pipeline (``ops.moe_ffn``): the fused GLU and down GEMM
    kernels above the small-M crossover, group-dense products below it."""
    cd = run.policy.compute_dtype
    return kops.moe_ffn(xs, wi_gate.to(cd), wi_up.to(cd), wo.to(cd),
                        group_sizes, row_scales=row_scales)


def apply_moe(params, cfg: ModelConfig, run: RunConfig, x):
    """Unsharded MoE block. x: [B, S, d] -> (y, aux)."""
    B, S, d = x.shape
    cd = run.policy.compute_dtype
    x2d = x.reshape(-1, d)
    weights, idx, aux = moe_route(params["router"], cfg, run.policy, x2d)
    T, k = idx.shape

    if run.moe_impl == "dense":
        # Every expert on every token; exact but O(E). TEST REFERENCE ONLY.
        g = torch.einsum("td,edf->tef", x2d, params["wi_gate"].to(cd))
        u = torch.einsum("td,edf->tef", x2d, params["wi_up"].to(cd))
        y_all = torch.einsum("tef,efd->ted", F.silu(g) * u,
                             params["wo"].to(cd))
        gates = torch.zeros((T, cfg.n_experts), dtype=cd, device=x.device)
        gates.index_put_((torch.arange(T, device=x.device)[:, None],
                          idx.long()), weights.to(cd), accumulate=True)
        y = torch.einsum("ted,te->td", y_all, gates)
        return y.reshape(B, S, d), aux

    # Dropless gather mode: sort token-copies by expert (stable, as
    # jnp.argsort), grouped FFN with the router weight fused in as a row
    # scale, then a bare per-token sum of the weighted rows.
    flat_idx = idx.reshape(-1)
    sort = torch.argsort(flat_idx, stable=True)
    tok = sort // k
    xs = x2d[tok]
    group_sizes = _bincount(flat_idx, cfg.n_experts).to(torch.int32)
    w_sorted = weights.reshape(-1)[sort].to(cd)
    ys = expert_ffn(params["wi_gate"], params["wi_up"], params["wo"], xs,
                    group_sizes, run, row_scales=w_sorted)
    # segment_sum over tokens: each token receives top_k rows; with top-2
    # the result 0 + a + b is the same in either order (IEEE addition of
    # two terms commutes), so the scatter order cannot change it.
    y = torch.zeros((T, d), dtype=ys.dtype, device=x.device)
    y.index_add_(0, tok, ys)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# SSD block (mamba2)
# ---------------------------------------------------------------------------

def causal_conv1d(x, conv_w, conv_b, state=None):
    """Depthwise causal conv. x: [B, S, C]; conv_w: [W, C]; state:
    [B, W-1, C]. The per-tap sum in x's dtype and the reference's order
    (not ``F.conv1d``, which goes through cuDNN: TF32 for f32 and another
    bf16 rounding). Returns (out [B, S, C], new_state [B, W-1, C])."""
    W = conv_w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * conv_w[i].to(x.dtype)
              for i in range(W))
    out = out + conv_b.to(x.dtype)
    new_state = xp[:, -(W - 1):, :] if W > 1 else pad
    return out, new_state


def init_ssd(cfg: ModelConfig):
    d = cfg.d_model
    din = cfg.ssm_expand * d
    nh, s, cw = cfg.ssm_heads, cfg.ssm_state, cfg.conv_width
    proj_out = 2 * din + 2 * s + nh  # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((d, proj_out), fan_in=d),
        "conv_w": ParamSpec((cw, din + 2 * s), fan_in=cw),
        "conv_b": ParamSpec((din + 2 * s,), "zeros"),
        "dt_bias": ParamSpec((nh,), "zeros"),
        "A_log": ParamSpec((nh,), "a_log"),  # A in [-16, -1]
        "D": ParamSpec((nh,), "ones"),
        "norm": ParamSpec((din,), "ones"),
        "out_proj": ParamSpec((din, d), fan_in=din),
    }


def _softplus(x):
    """``jax.nn.softplus`` (= logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def apply_ssd(params, cfg: ModelConfig, run: RunConfig, x, state=None):
    """mamba2 SSD mixer. x: [B, S, d] -> (y, new_state).

    Without a state (training, cache-free forward) the scan is
    ``ops.ssd``: the SSD scan kernel on the card, its plain version on the
    CPU, and the backward by autograd of ``ref.ssd_chunked``; that is the
    JAX package's ``use_gmm_kernel=True`` route, the only one the port has.
    With a state ({"conv", "ssm"}, :func:`init_ssd_state`) it is the
    sequential ``ref.ssd_decode_step``, as in the JAX package."""
    cd = run.policy.compute_dtype
    B, S, d = x.shape
    din = cfg.ssm_expand * d
    nh, ns = cfg.ssm_heads, cfg.ssm_state
    hd = din // nh

    zxbcdt = x @ params["in_proj"].to(cd)
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * ns]
    dt_raw = zxbcdt[..., -nh:]

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = causal_conv1d(xbc, params["conv_w"], params["conv_b"],
                                  conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :din].reshape(B, S, nh, hd)
    Bm = xbc[..., din:din + ns]
    Cm = xbc[..., din + ns:]

    dt = _softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])  # [nh]

    if state is None:
        y, last_state = kops.ssd(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        y, last_state = kref.ssd_decode_step(xs, dt, A, Bm, Cm,
                                             state["ssm"].float())

    y = y + params["D"].to(cd)[None, None, :, None] * xs
    y = y.reshape(B, S, din)
    # Gated RMSNorm (mamba2): norm(y * silu(z))
    yf = (y * F.silu(z)).float()
    ms = yf.square().mean(-1, keepdim=True)
    yf = yf * torch.rsqrt(ms + 1e-6) * params["norm"]
    out = yf.to(cd) @ params["out_proj"].to(cd)

    new_state = None
    if state is not None:
        new_state = {"conv": new_conv.to(state["conv"].dtype),
                     "ssm": last_state.to(state["ssm"].dtype)}
    return out, new_state


def init_ssd_state(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    din = cfg.ssm_expand * cfg.d_model
    nh, ns = cfg.ssm_heads, cfg.ssm_state
    hd = din // nh
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, din + 2 * ns),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, hd, ns), dtype=torch.float32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# Transformer layer = mixer + ffn
# ---------------------------------------------------------------------------

def _check_spec(spec: LayerSpec):
    if spec.mixer not in ("attn", "local_attn", "ssd") or spec.cross_attn:
        raise NotImplementedError(f"layer kind {spec.tag()!r} is not ported "
                                  f"yet (attention and SSD mixers only)")


def _check_decode_spec(spec: LayerSpec):
    _check_spec(spec)
    if spec.mixer == "ssd":
        raise NotImplementedError("the serving engines' recurrent (SSD) "
                                  "decode state is not ported yet")


def init_layer(cfg: ModelConfig, spec: LayerSpec):
    _check_spec(spec)
    mixer = init_ssd(cfg) if spec.mixer == "ssd" else init_attention(cfg)
    params = {"norm1": init_norm(cfg), "mixer": mixer}
    if spec.ffn != "none":
        params["norm2"] = init_norm(cfg)
        params["ffn"] = init_moe(cfg) if spec.ffn == "moe" else init_mlp(cfg)
    return params


def apply_mixer_part(params, cfg: ModelConfig, run: RunConfig,
                     spec: LayerSpec, x, positions, state=None,
                     cache_index=None, page_table=None):
    """Pre-norm mixer (attention or SSD) + residual. Returns (h,
    new_state)."""
    _check_spec(spec)
    new_state = dict(state) if state is not None else None
    u = apply_norm(params["norm1"], x, run.policy)
    if spec.mixer == "ssd":
        mixed, ns = apply_ssd(params["mixer"], cfg, run, u,
                              state.get("ssd") if state else None)
        if new_state is not None:
            new_state["ssd"] = ns
        return x + mixed, new_state
    window = cfg.window if spec.mixer == "local_attn" else 0
    causal = cfg.causal if spec.causal is None else spec.causal
    cache = state.get("kv") if state is not None else None
    att, new_kv = apply_attention(
        params["mixer"], cfg, run, u, positions, causal=causal,
        window=window, cache=cache, cache_index=cache_index,
        page_table=page_table)
    if new_state is not None:
        new_state["kv"] = new_kv
    return x + att, new_state


def apply_ffn_part(params, cfg: ModelConfig, run: RunConfig, spec: LayerSpec,
                   h):
    """Pre-norm FFN + residual. Returns (y, aux)."""
    if spec.ffn == "none":
        return h, {}
    u = apply_norm(params["norm2"], h, run.policy)
    if spec.ffn == "moe":
        f, aux = apply_moe(params["ffn"], cfg, run, u)
    else:
        f, aux = apply_mlp(params["ffn"], cfg, run, u), {}
    return h + f, aux


def apply_layer(params, cfg: ModelConfig, run: RunConfig, spec: LayerSpec,
                x, positions, state=None, cache_index=None, page_table=None):
    h, new_state = apply_mixer_part(params, cfg, run, spec, x, positions,
                                    state=state, cache_index=cache_index,
                                    page_table=page_table)
    y, aux = apply_ffn_part(params, cfg, run, spec, h)
    return y, new_state, aux


def init_layer_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device="cpu"):
    """Decode-state tree for one layer (dense per-slot cache layout)."""
    _check_decode_spec(spec)
    window = cfg.window if spec.mixer == "local_attn" else 0
    return {"kv": init_attention_cache(cfg, batch, max_len, window, dtype,
                                       device)}


def init_paged_layer_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
                           n_pages: int, page_size: int, dtype,
                           device="cpu"):
    """Paged decode-state tree for one layer (DESIGN.md §9): attention KV
    is the SHARED pool (no batch dim)."""
    del batch  # per-slot recurrent states belong to unported mixers
    _check_decode_spec(spec)
    return {"kv": init_paged_attention_cache(cfg, n_pages, page_size, dtype,
                                             device)}
