"""Neural-net modules of the serving and training main paths (mirror of
``repro/models/modules.py``): norms, RoPE, embeddings, GQA attention
(cache-free reference, chunked and flash; dense per-slot and ring caches;
paged), the dense and MoE FFNs, and the layer glue.

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
scan kernel, its cached path through ``ref.ssd_decode_step``), the
recurrentgemma RG-LRU mixer (its linear recurrence a doubling scan in plain
torch, as the JAX package's ``associative_scan`` is plain ``jnp``), layers
without a mixer (mixer ``"none"``), cross-attention over an encoder or
vision memory (whisper, llama-3.2-vision: no RoPE, not causal, no cache,
added through ``tanh(xgate)``), learned absolute positions (whisper) and
dense / MoE FFNs. The engines' decode states hold an attention cache (dense
or paged) per attention layer and a per-slot recurrent state ({"conv",
"lru"} or {"conv", "ssm"}) per RG-LRU or SSD layer, in both layouts; a
layer without a mixer holds none (``{}``).

Training runs these functions under autograd. The in-place writes on the
cache-free path are autograd-safe: ``apply_moe``'s combine ``index_add_``
writes into a fresh zero tensor that no backward reads, and the dense and
paged KV updates, which write into the serving caches in place, run only
with a cache, never in training.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

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
    # the mesh program's collectives (``train.step.ShardContext``): None on
    # one device. It reduces tensor-parallel attention outputs over
    # "model" and takes the MoE router's load statistics over the batch
    # shards; the serve engines never set it.
    shard: Any = None

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
        return {"scale": ParamSpec((dim,), "ones", axes=("embed",)),
                "bias": ParamSpec((dim,), "zeros", axes=("embed",))}
    return {"scale": ParamSpec((dim,), "ones", axes=("embed",))}


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
    params = {"table": ParamSpec((cfg.vocab_size, cfg.d_model),
                                 fan_in=cfg.d_model, axes=("vocab", "embed"))}
    if cfg.learned_pos:  # learned absolute positions (whisper)
        params["pos"] = ParamSpec((cfg.max_seq_len, cfg.d_model),
                                  fan_in=cfg.d_model, axes=(None, "embed"))
    return params


def apply_embedding(params, cfg: ModelConfig, policy: Policy, tokens,
                    positions=None):
    """Token embedding (scaled by sqrt(d) under ``emb_scale``), plus the
    learned position rows ``pos[positions]`` in the compute dtype where
    the tree has them and ``positions`` [B, S] is given."""
    cd = policy.compute_dtype
    x = params["table"][tokens.long()].to(cd)
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd,
                             device=x.device)
    if "pos" in params and positions is not None:
        x = x + params["pos"][positions.long()].to(cd)
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

def init_attention(cfg: ModelConfig, cross: bool = False):
    """Attention projections; a cross-attention (``cross``) has no q/k
    norm, as the reference's."""
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params = {
        "wq": ParamSpec((d, h * hd), fan_in=d, axes=("embed", "q_heads")),
        "wk": ParamSpec((d, kh * hd), fan_in=d, axes=("embed", "kv_heads")),
        "wv": ParamSpec((d, kh * hd), fan_in=d, axes=("embed", "kv_heads")),
        "wo": ParamSpec((h * hd, d), fan_in=h * hd,
                        axes=("q_heads", "embed")),
    }
    if cfg.qk_norm and not cross:
        params["q_norm"] = ParamSpec((hd,), "ones", axes=(None,))
        params["k_norm"] = ParamSpec((hd,), "ones", axes=(None,))
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
    cache-free path: queries at 0..S-1, keys at 0..T-1, T the memory's
    length under cross-attention); flash masks from those positions itself
    and is not handed them."""
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
                 kv=None, kv_positions=None, rope: bool = True):
    """q/k/v projection + qk-norm + rope. K and V come from the memory
    ``kv`` [B, T, d] where it is given (cross-attention: no RoPE), else
    from x. Returns (q, k, v, kv_pos)."""
    B, S, _ = x.shape
    # the head counts of the weights given: a tensor-parallel rank holds
    # its own heads' columns (and the matching kv heads)
    hd = cfg.head_dim
    h, kh = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    pol = run.policy
    cd = pol.compute_dtype
    kv_src = kv if kv is not None else x
    kv_pos = kv_positions if kv_positions is not None else positions
    q = (x @ params["wq"].to(cd)).reshape(B, S, h, hd)
    k = (kv_src @ params["wk"].to(cd)).reshape(B, -1, kh, hd)
    v = (kv_src @ params["wv"].to(cd)).reshape(B, -1, kh, hd)
    if "q_norm" in params:
        q = rms_norm_headwise(params["q_norm"], q, pol)
        k = rms_norm_headwise(params["k_norm"], k, pol)
    if rope and cfg.rope_theta > 0 and kv is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    return q, k, v, kv_pos


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


def _write_dense_cache(cache, k, v, positions, cache_index, window: int):
    """Write this step's K/V/positions into a dense cache, IN PLACE (the
    JAX package's four write cases of ``apply_attention``).

    cache: k/v [B, C, KH, hd], pos [B, C]; a ring (``window`` > 0) holds
    position p at line p % C. A vector ``cache_index`` [B] (decode, one
    token) writes line cache_index[b] of row b; a row with a negative
    index (or a linear line past C) writes nothing: JAX sends it to the
    out-of-bounds sentinel C and drops it, here it rewrites line 0 with
    what line 0 holds (an in-bounds write, no host sync). A scalar writes
    lines [offset, offset + S): a block larger than the ring keeps its
    last C keys, rolled to their ring lines; a chunk into a ring scatters
    per position modulo C (it may cross the ring's edge); otherwise one
    slice, its start clamped as ``dynamic_update_slice`` clamps it."""
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    B, C = cpos.shape
    S = k.shape[1]
    pos = positions.to(cpos.dtype)
    if getattr(cache_index, "ndim", 0) == 1:
        if S != 1:
            raise ValueError("a per-slot cache_index implies single-token "
                             "decode")
        ci = torch.as_tensor(cache_index, device=k.device).long()
        line = ci % C if window > 0 else ci
        keep = (ci >= 0) & (line < C)
        line = torch.where(keep, line, 0)
        b = torch.arange(B, device=ci.device)
        for dst, new in ((ck, k[:, 0]), (cv, v[:, 0]), (cpos, pos[:, 0])):
            old = dst[b, line]
            mask = keep.view(-1, *([1] * (old.dim() - 1)))
            dst[b, line] = torch.where(mask, new.to(dst.dtype), old)
        return
    ci = int(cache_index)
    if window > 0 and S >= C:
        shift = (ci + S - C) % C
        for dst, new in ((ck, k), (cv, v), (cpos, pos)):
            dst.copy_(torch.roll(new[:, -C:], shift, dims=1))
    elif window > 0 and S > 1:
        idx = (ci + torch.arange(S, device=k.device)) % C
        for dst, new in ((ck, k), (cv, v), (cpos, pos)):
            dst[:, idx] = new.to(dst.dtype)
    else:
        start = min(max(ci % C if window > 0 else ci, 0), C - S)
        for dst, new in ((ck, k), (cv, v), (cpos, pos)):
            dst[:, start:start + S] = new.to(dst.dtype)


def apply_attention(params, cfg: ModelConfig, run: RunConfig, x, positions,
                    *, causal: bool, window: int = 0, kv=None,
                    kv_positions=None, cache=None, cache_index=None,
                    rope: bool = True, attend_to_cache: bool = False,
                    page_table=None):
    """Full / sliding-window self-attention, cache-free, dense or paged,
    and cross-attention.

    x: [B, S, d]; positions: [B, S]. ``kv`` [B, T, d] is a cross-attention
    memory (``kv_positions`` [B, T]): K and V are projected from it, with
    no RoPE, and every query attends over all of it, not causally and
    without a cache, through the path ``run.attn_impl`` picks, at decode
    too (the reference's). Without a cache, attention runs over
    the fresh K/V with the structural mask. With ``page_table`` [B, MP],
    ``cache`` holds the shared physical pool and row b's cache line p
    lives at line p % ps of page page_table[b, p // ps] (see
    :func:`_apply_attention_paged`). Otherwise ``cache`` is the dense
    per-slot cache (k/v [B, C, KH, hd], pos [B, C]; a ring on a
    sliding-window layer), written in place by :func:`_write_dense_cache`
    and returned (the same dict). ``cache_index`` is a scalar (lockstep
    decode, prefill offset) or a per-slot [B] vector (continuous decode;
    negative rows write nothing). ``attend_to_cache``: an S > 1 chunk
    attends over the cache (chunked prefill) instead of assuming it
    empty. Decode and chunked prefill attend through the materialised
    plain path (lines with pos == -1 masked out), a ring's chunk over the
    PRE-write ring plus its own keys, since its tail may evict lines its
    earlier queries still see; whole-sequence prefill attends
    structurally over the fresh K/V, the cache write a side effect.
    """
    if cache is not None and page_table is not None:
        return _apply_attention_paged(
            params, cfg, run, x, positions, causal=causal, window=window,
            cache=cache, cache_index=cache_index, rope=rope,
            page_table=page_table)
    B, S, _ = x.shape
    cd = run.policy.compute_dtype
    q, k, v, kv_pos = _project_qkv(params, cfg, run, x, positions, kv,
                                   kv_positions, rope)
    structural = cache is None or not (S == 1 or attend_to_cache)
    if cache is not None:
        ring_chunk = window > 0 and S > 1 and not structural
        if ring_chunk:  # attend before the write lands (cat copies)
            seen = [torch.cat([cache[n], t.to(cache[n].dtype)], dim=1)
                    for n, t in (("k", k), ("v", v), ("pos", positions))]
        _write_dense_cache(cache, k, v, positions, cache_index, window)
        if ring_chunk:
            k, v, kv_pos = seen
        elif not structural:
            k, v, kv_pos = cache["k"], cache["v"], cache["pos"]
    out = _attention_inner(q, k, v, cfg, run, positions=positions,
                           kv_pos=kv_pos, causal=causal and kv is None,
                           window=window, structural=structural)
    y = out.reshape(B, S, -1) @ params["wo"].to(cd)
    return y, cache


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
        return {"wi_gate": ParamSpec((d, f), fan_in=d, axes=("embed", "mlp")),
                "wi_up": ParamSpec((d, f), fan_in=d, axes=("embed", "mlp")),
                "wo": ParamSpec((f, d), fan_in=f, axes=("mlp", "embed"))}
    return {"wi": ParamSpec((d, f), fan_in=d, axes=("embed", "mlp")),  # gelu
            "bi": ParamSpec((f,), "zeros", axes=("mlp",)),
            "wo": ParamSpec((f, d), fan_in=f, axes=("mlp", "embed")),
            "bo": ParamSpec((d,), "zeros", axes=("embed",))}


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
        "router": ParamSpec((d, e), fan_in=d, axes=("embed", None)),
        "wi_gate": ParamSpec((e, d, f), fan_in=d,
                             axes=("expert", "embed", "mlp")),
        "wi_up": ParamSpec((e, d, f), fan_in=d,
                           axes=("expert", "embed", "mlp")),
        "wo": ParamSpec((e, f, d), fan_in=f, axes=("expert", "mlp", "embed")),
    }


def _bincount(x, length: int):
    """``jnp.bincount(x, length=length)`` as a scatter-add: same counts as
    ``torch.bincount(x, minlength=length)`` for x < length, without the
    host sync bincount takes on CUDA to size its output."""
    return torch.zeros(length, dtype=torch.int64, device=x.device) \
        .index_add_(0, x.long(), torch.ones_like(x, dtype=torch.int64))


def moe_route(router_w, cfg: ModelConfig, policy: Policy, x2d,
              stats_mean=None):
    """Router in f32: returns (weights [T,k], idx [T,k] int32, aux dict).
    ``stats_mean`` (the mesh program's mean over the batch shards) makes
    the load-balance statistics and the z-loss those of the global token
    batch, as the JAX package computes them outside a ``shard_map``."""
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
    z = torch.logsumexp(logits, -1).square().mean()
    if stats_mean is not None:
        f, p, z = stats_mean(f), stats_mean(p), stats_mean(z)
    aux = {
        "moe_aux_loss": cfg.n_experts * (f * p).sum() * cfg.router_aux_coef,
        "moe_z_loss": z * cfg.router_z_coef,
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
    weights, idx, aux = moe_route(
        params["router"], cfg, run.policy, x2d,
        stats_mean=run.shard.batch_mean if run.shard is not None else None)
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
        "in_proj": ParamSpec((d, proj_out), fan_in=d, axes=("embed", "mlp")),
        "conv_w": ParamSpec((cw, din + 2 * s), fan_in=cw, axes=(None, "mlp")),
        "conv_b": ParamSpec((din + 2 * s,), "zeros", axes=("mlp",)),
        "dt_bias": ParamSpec((nh,), "zeros", axes=(None,)),
        "A_log": ParamSpec((nh,), "a_log", axes=(None,)),  # A in [-16, -1]
        "D": ParamSpec((nh,), "ones", axes=(None,)),
        "norm": ParamSpec((din,), "ones", axes=("mlp",)),
        "out_proj": ParamSpec((din, d), fan_in=din, axes=("mlp", "embed")),
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
# RG-LRU recurrent block (recurrentgemma / Griffin)
# ---------------------------------------------------------------------------

def init_rglru(cfg: ModelConfig):
    d, w, cw = cfg.d_model, cfg.lru_width, cfg.conv_width
    return {
        "proj_gate": ParamSpec((d, w), fan_in=d, axes=("embed", "mlp")),
        "proj_rec": ParamSpec((d, w), fan_in=d, axes=("embed", "mlp")),
        "conv_w": ParamSpec((cw, w), fan_in=cw, axes=(None, "mlp")),
        "conv_b": ParamSpec((w,), "zeros", axes=("mlp",)),
        "w_i": ParamSpec((w, w), fan_in=w, axes=("mlp", "mlp_out")),
        "b_i": ParamSpec((w,), "zeros", axes=("mlp",)),
        "w_a": ParamSpec((w, w), fan_in=w, axes=("mlp", "mlp_out")),
        "b_a": ParamSpec((w,), "zeros", axes=("mlp",)),
        # sigmoid(lam)^8 in (0.9, 0.999)
        "lam": ParamSpec((w,), "lam", axes=("mlp",)),
        "out": ParamSpec((w, d), fan_in=w, axes=("mlp", "embed")),
    }


def _lru_scan(a, gx, h0=None):
    """Linear recurrence h_t = a_t * h_{t-1} + gx_t along axis 1 (f32).

    ``h0`` is folded into the first step, as the reference folds it. The
    reference's ``jax.lax.associative_scan`` becomes a doubling
    (Hillis-Steele) scan: log2(S) out-of-place elementwise passes over
    [B, S, w], each combining every element with the one ``d`` steps back
    ((a1, b1), (a2, b2)) -> (a1 a2, a2 b1 + b2), so autograd differentiates
    it as it stands and no Python loop runs over time."""
    if h0 is not None:
        gx = torch.cat([gx[:, :1] + a[:, :1] * h0[:, None], gx[:, 1:]], 1)
    S = gx.shape[1]
    d = 1
    while d < S:
        gx = torch.cat([gx[:, :d], a[:, d:] * gx[:, :-d] + gx[:, d:]], 1)
        if 2 * d < S:  # the last pass needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return gx


def apply_rglru(params, cfg: ModelConfig, run: RunConfig, x, state=None):
    """Griffin recurrent block. x: [B, S, d] -> (y, new_state).

    The gates are f32 (``w_i`` and ``w_a`` are cast to f32 at use, so
    ``stack.compute_params`` leaves them f32), the recurrence is
    :func:`_lru_scan` in f32. With a state ({"conv", "lru"},
    :func:`init_rglru_state`) the conv starts from its last taps and the
    scan from ``lru``, and the new state is returned in the state's
    dtypes."""
    cd = run.policy.compute_dtype
    gate = F.gelu(x @ params["proj_gate"].to(cd), approximate="tanh")
    h = x @ params["proj_rec"].to(cd)
    conv_state = state["conv"] if state is not None else None
    h, new_conv = causal_conv1d(h, params["conv_w"], params["conv_b"],
                                conv_state)
    hf = h.float()
    i_gate = torch.sigmoid(hf @ params["w_i"].float() + params["b_i"])
    r_gate = torch.sigmoid(hf @ params["w_a"].float() + params["b_a"])
    log_a = -8.0 * r_gate * _softplus(params["lam"])  # [B, S, w]
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-6)) \
        * (i_gate * hf)
    h0 = state["lru"].float() if state is not None else None
    hs = _lru_scan(a, gated, h0)
    y = (hs.to(cd) * gate) @ params["out"].to(cd)
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv.to(state["conv"].dtype),
                     "lru": hs[:, -1].to(state["lru"].dtype)}
    return y, new_state


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device="cpu"):
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                            dtype=dtype, device=device),
        "lru": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# Transformer layer = mixer + (optional cross-attention) + ffn
# ---------------------------------------------------------------------------

_MIXERS = {"attn": init_attention, "local_attn": init_attention,
           "rglru": init_rglru, "ssd": init_ssd}


def init_layer(cfg: ModelConfig, spec: LayerSpec):
    """One layer's tree in the reference's order: ``norm1`` (kept on a
    layer without a mixer, as the reference keeps it), the mixer, the
    cross-attention's ``xnorm``, ``xattn`` and its 0-dim f32 gate
    ``xgate`` (zero at init), then ``norm2`` and the FFN."""
    params = {"norm1": init_norm(cfg)}
    if spec.mixer != "none":
        params["mixer"] = _MIXERS[spec.mixer](cfg)
    if spec.cross_attn:
        params["xnorm"] = init_norm(cfg)
        params["xattn"] = init_attention(cfg, cross=True)
        params["xgate"] = ParamSpec((), "zeros", axes=())
    if spec.ffn != "none":
        params["norm2"] = init_norm(cfg)
        params["ffn"] = init_moe(cfg) if spec.ffn == "moe" else init_mlp(cfg)
    return params


def apply_mixer_part(params, cfg: ModelConfig, run: RunConfig,
                     spec: LayerSpec, x, positions, state=None,
                     encoder_out=None, encoder_positions=None,
                     cache_index=None, attend_to_cache: bool = False,
                     page_table=None):
    """Pre-norm mixer (attention, RG-LRU, SSD or none) + residual, then on
    a cross-attention layer ``tanh(xgate)`` times the cross-attention of
    ``xnorm(h)`` over ``encoder_out`` (the gate's tanh taken in f32, then
    cast to h's dtype, as the reference). Returns (h, new_state)."""
    new_state = dict(state) if state is not None else None
    h = x
    if spec.mixer != "none":
        u = apply_norm(params["norm1"], x, run.policy)
        if spec.mixer in ("rglru", "ssd"):
            apply = apply_rglru if spec.mixer == "rglru" else apply_ssd
            mixed, ns = apply(params["mixer"], cfg, run, u,
                              state.get(spec.mixer) if state else None)
            if new_state is not None:
                new_state[spec.mixer] = ns
        else:
            window = cfg.window if spec.mixer == "local_attn" else 0
            causal = cfg.causal if spec.causal is None else spec.causal
            cache = state.get("kv") if state is not None else None
            mixed, new_kv = apply_attention(
                params["mixer"], cfg, run, u, positions, causal=causal,
                window=window, cache=cache, cache_index=cache_index,
                attend_to_cache=attend_to_cache, page_table=page_table)
            if new_state is not None:
                new_state["kv"] = new_kv
            if run.shard is not None:  # tensor-parallel partial sums
                mixed = run.shard.attn_reduce(mixed)
        h = x + mixed
    if spec.cross_attn:
        u = apply_norm(params["xnorm"], h, run.policy)
        xa, _ = apply_attention(params["xattn"], cfg, run, u, positions,
                                causal=False, kv=encoder_out,
                                kv_positions=encoder_positions)
        if run.shard is not None:
            xa = run.shard.attn_reduce(xa)
        h = h + torch.tanh(params["xgate"]).to(h.dtype) * xa
    return h, new_state


def apply_ffn_part(params, cfg: ModelConfig, run: RunConfig, spec: LayerSpec,
                   h, moe_override: Optional[Callable] = None):
    """Pre-norm FFN + residual. Returns (y, aux). ``moe_override(ffn_params,
    u)`` -> (f, aux) replaces ``apply_moe`` on a MoE layer (the lockstep
    server's expert-parallel MoE)."""
    if spec.ffn == "none":
        return h, {}
    u = apply_norm(params["norm2"], h, run.policy)
    if spec.ffn == "moe":
        f, aux = (moe_override(params["ffn"], u) if moe_override is not None
                  else apply_moe(params["ffn"], cfg, run, u))
    else:
        f, aux = apply_mlp(params["ffn"], cfg, run, u), {}
    return h + f, aux


def apply_layer(params, cfg: ModelConfig, run: RunConfig, spec: LayerSpec,
                x, positions, state=None, encoder_out=None,
                encoder_positions=None, cache_index=None,
                moe_override: Optional[Callable] = None,
                attend_to_cache: bool = False, page_table=None):
    h, new_state = apply_mixer_part(
        params, cfg, run, spec, x, positions, state=state,
        encoder_out=encoder_out, encoder_positions=encoder_positions,
        cache_index=cache_index, attend_to_cache=attend_to_cache,
        page_table=page_table)
    y, aux = apply_ffn_part(params, cfg, run, spec, h,
                            moe_override=moe_override)
    return y, new_state, aux


def init_layer_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device="cpu"):
    """Decode-state tree for one layer (dense per-slot cache layout): the
    attention cache (a ring of ``window`` lines on sliding-window layers),
    the per-slot recurrent state, or nothing (``{}``) for a layer without
    a mixer (the cross-attention keeps no cache)."""
    if spec.mixer == "none":
        return {}
    if spec.mixer == "rglru":
        return {"rglru": init_rglru_state(cfg, batch, dtype, device)}
    if spec.mixer == "ssd":
        return {"ssd": init_ssd_state(cfg, batch, dtype, device)}
    window = cfg.window if spec.mixer == "local_attn" else 0
    return {"kv": init_attention_cache(cfg, batch, max_len, window, dtype,
                                       device)}


def init_paged_layer_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
                           n_pages: int, page_size: int, dtype,
                           device="cpu"):
    """Paged decode-state tree for one layer (DESIGN.md §9): attention KV
    is the SHARED pool (no batch dim); recurrent states stay per-slot
    (they are O(d) per slot: paging buys nothing there); a layer without
    a mixer holds nothing."""
    if spec.mixer in ("rglru", "ssd", "none"):
        return init_layer_state(cfg, spec, batch, 0, dtype, device)
    return {"kv": init_paged_attention_cache(cfg, n_pages, page_size, dtype,
                                             device)}
