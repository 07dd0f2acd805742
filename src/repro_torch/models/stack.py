"""Model assembly: embedding -> stacked block loop -> head (mirror of
``repro/models/stack.py``).

Params keep the JAX package's stacked layout: the layer ``pattern`` repeated
``n_pattern_repeats`` times is one tree per pattern position
(``blocks/pos{i}/...``) whose leaves carry a leading layer axis, plus
unrolled ``tail{i}`` layers. ``_apply_stack`` is a Python loop over that
axis (the JAX package's ``lax.scan``). Decode states use the same stacked
layout, so one layer's KV pool ``[P, ps, KH, hd]`` (or dense cache ``[B,
C, KH, hd]``) is a contiguous view of the stacked leaf that the kernels
read and that the attention updates in place.

Training runs the same forward under autograd on the f32 params, whose
matrices are cast to the compute dtype at their use in the graph, as in
the JAX package (not through :func:`compute_params`, which would cut the
gradient off the f32 params). With ``RunConfig(remat="full")`` each layer
is checkpointed (the JAX package's ``jax.checkpoint`` of the scan body):
its activations are recomputed in the backward; ``remat="dots"`` saves
the outputs of its matrix products without batch dims and recomputes the
rest (``torch.utils.checkpoint``'s selective checkpoint under
``modules.dots_with_no_batch_dims_saveable``). A ``layer_override``
(zebra parallelism, ``core/zebra_spmd.py``) replaces every MoE layer
without decode state, inside the checkpoint, so the recompute reruns it.

The cross-attention archs carry a memory beside the token stream
(:func:`cross_memory`): whisper's ``encoder`` (a stack of bidirectional
layers over the front embeddings plus the decoder's learned position
rows) or the vision archs' ``vision_proj`` of the patch embeddings. It is
built at every ``apply_model`` call, decode steps included, as the
reference builds it, and handed to each checkpointed block as an
argument.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import modules
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import ParamSpec, flatten, materialize, tree_map
from repro_torch.sharding import collectives as C

AUX_KEYS = ("moe_aux_loss", "moe_z_loss")
# whisper's encoder layer: bidirectional self-attention and a dense FFN
ENCODER_SPEC = LayerSpec(mixer="attn", ffn="dense", causal=False)

# Leaves cast to the compute dtype at their use in the JAX package
# (``.astype(cd)``; the SSD and RG-LRU conv taps and bias are cast to x's
# dtype, the compute dtype, inside ``causal_conv1d``). Norm scales and the
# router stay f32: they are used in the accum dtype; so do the SSD's
# dt_bias, A_log and norm, and its D, which is cast at its use from f32, and
# the RG-LRU's gate matrices w_i / w_a (cast to f32 at use), their biases
# and lam.
_COMPUTE_LEAVES = ("table", "lm_head", "wq", "wk", "wv", "wo", "wi_gate",
                   "wi_up", "wi", "in_proj", "out_proj", "conv_w", "conv_b",
                   "proj_gate", "proj_rec", "out", "vision_proj")


def _zero_aux(device, extras=()):
    """Zero aux accumulator. ``extras`` adds fixed-shape keys (``(key,
    shape)`` pairs), e.g. the EP decode step's per-expert routing counts."""
    z = {k: torch.zeros((), dtype=torch.float32, device=device)
         for k in AUX_KEYS}
    for k, shape in extras:
        z[k] = torch.zeros(shape, dtype=torch.float32, device=device)
    return z


def _acc_aux(acc, aux):
    # the ACCUMULATOR's keys: a layer's other aux entries are dropped
    # unless the caller registered them as extras
    return {k: acc[k] + aux[k].float() if k in aux else acc[k] for k in acc}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_specs(cfg: ModelConfig, pattern, n: int):
    """One stacked tree per pattern position, leading layer axis ``n``."""
    return {f"pos{p}": tree_map(lambda s: s.stacked(n),
                                modules.init_layer(cfg, spec))
            for p, spec in enumerate(pattern)}


def param_specs(cfg: ModelConfig):
    """The parameter tree as ParamSpecs (shape + initializer), in the JAX
    package's ``split_params`` layout: the decoder, then whisper's
    ``encoder`` (``blocks`` of ``ENCODER_SPEC`` stacked
    ``n_encoder_layers`` times, ``final_norm``) and the vision archs'
    ``vision_proj`` [vision_dim, d]."""
    specs = {"embed": modules.init_embedding(cfg)}
    n = cfg.n_pattern_repeats
    if n > 0:
        specs["blocks"] = _block_specs(cfg, cfg.pattern, n)
    for i, spec in enumerate(cfg.tail_specs):
        specs[f"tail{i}"] = modules.init_layer(cfg, spec)
    specs["final_norm"] = modules.init_norm(cfg)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                                     fan_in=cfg.d_model,
                                     axes=("vocab", "embed"))
    if cfg.is_encdec:
        specs["encoder"] = {
            "blocks": _block_specs(cfg, (ENCODER_SPEC,),
                                   cfg.n_encoder_layers),
            "final_norm": modules.init_norm(cfg)}
    if cfg.vision_seq > 0:
        vdim = cfg.vision_dim or cfg.d_model
        specs["vision_proj"] = ParamSpec((vdim, cfg.d_model), fan_in=vdim,
                                         axes=(None, "embed"))
    return specs


def flat_param_specs(cfg: ModelConfig) -> dict:
    """{'blocks/pos0/mixer/wq': ParamSpec, ...}"""
    return flatten(param_specs(cfg))


def param_axes(cfg: ModelConfig) -> dict:
    """{path: logical axes} of every leaf (the JAX package's
    ``abstract_params(cfg)[1]``, flattened): one name or None per dim,
    ``"layers"`` first on a stacked leaf."""
    return {k: s.axes for k, s in flat_param_specs(cfg).items()}


def init_model(generator: torch.Generator, cfg: ModelConfig, *,
               device="cpu"):
    """Seeded f32 parameter tree on ``device`` (values drawn from
    ``generator``; the JAX package's init cannot be reproduced, so parity
    tests bring JAX weights in through ``pytree.params_from_jax``)."""
    return materialize(param_specs(cfg), generator, device)


def compute_params(params, policy: Policy):
    """The tree the model runs on: every matrix cast ONCE to the compute
    dtype (bit-identical to the JAX package's cast at each use), norms and
    router kept as they are. The f32 params are left untouched; under an
    f32 policy the result shares their tensors."""
    cd = policy.compute_dtype

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else (v.to(cd) if k in _COMPUTE_LEAVES else v)
                for k, v in tree.items()}
    return walk(params)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _unbind_layers(tree, n: int):
    """Per-layer views of a stacked tree of ``n`` layers: a list over the
    leading layer axis of trees of the same structure (an empty dict, the
    state of a layer without a mixer, gives ``n`` empty dicts). ``unbind``
    (not ``v[i]`` per layer) gives autograd one node per stacked leaf,
    whose backward stacks the layer gradients once instead of summing one
    full-size zero-padded gradient per layer."""
    if isinstance(tree, dict):
        subs = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return tree.unbind(0)


def _apply_layer(p, cfg, run, spec, x, positions, state, cache_index,
                 page_table, layer_override, moe_override=None,
                 attend_to_cache=False, memory=None, seq=None):
    """One layer: ``layer_override`` (zebra) for a MoE layer without decode
    state, else ``modules.apply_layer``; ``memory`` is the cross-attention
    memory (encoder_out, encoder_positions) or None. ``seq`` (a block's
    last layer under a ``train.step.SeqPlan``): the output is this rank's
    seq block, the override's sum over the ranks fused with the cut into
    one reduce-scatter. Returns (x, new_state, aux)."""
    if layer_override is not None and spec.ffn == "moe" and state is None:
        y, aux = layer_override(p, spec, x, positions, seq=seq)
        return y, None, aux
    enc, enc_pos = memory if memory is not None else (None, None)
    return modules.apply_layer(
        p, cfg, run, spec, x, positions, state=state, encoder_out=enc,
        encoder_positions=enc_pos, cache_index=cache_index,
        moe_override=moe_override, attend_to_cache=attend_to_cache,
        page_table=page_table, seq=seq)


def _write_recurrent(state, new_state) -> None:
    """Copy a layer's new recurrent state ("rglru" / "ssd") into its decode
    state's tensors, in place (the attention cache under "kv" is already
    written in place). The new tensors are fresh (a ``torch.cat`` slice,
    the scan's last row), so the copy never reads what it overwrites."""
    for kind, leaves in state.items():
        if kind != "kv":
            for k, dst in leaves.items():
                dst.copy_(new_state[kind][k])


def _apply_stack(blocks, tails, cfg: ModelConfig, run: RunConfig, pattern,
                 x, positions, states=None, tail_states=None,
                 cache_index=None, page_table=None,
                 layer_override: Optional[Callable] = None,
                 moe_override: Optional[Callable] = None,
                 attend_to_cache: bool = False, aux_extras=(),
                 layer_aux: bool = False, memory=None,
                 prefix: str = "blocks", seq=None):
    """Run the stacked pattern layers + tail. Returns (x, new_states, aux).

    ``memory`` (encoder_out [B, T, d], encoder_positions [B, T]; see
    :func:`cross_memory`) is what every cross-attention layer attends
    over. Under remat it is an argument of each checkpointed block, so its
    gradient (to whisper's encoder, to ``vision_proj``) flows through the
    recompute.

    ``aux_extras`` registers extra fixed-shape aux keys (``(key, shape)``
    pairs) summed over the layers beside the aux losses. With
    ``layer_aux`` the aux dict also carries ``aux["per_layer"]``: each key
    stacked one row per layer, the stacked layers first (pattern positions
    within a repeat summed), then one row per tail, the reference's row
    order. The EP decode step returns its routing histograms through them.

    Block states are per-layer views of the stacked leaves and are updated
    in place, tail states too, so ``new_states`` holds the same tensors as
    ``states``: attention writes its caches in place, and the new
    recurrent states that the RG-LRU and SSD mixers return as fresh
    tensors are copied into the views (:func:`_write_recurrent`).
    Without states and with ``run.remat`` "full" or "dots" each repeat of
    the pattern is one checkpoint (recomputed in the backward, the
    ``layer_override`` with it; under "dots" but for the products that
    ``modules.dots_with_no_batch_dims_saveable`` saves).

    On a mesh (``run.shard``) each layer's weights are all-gathered at the
    block's start, inside its checkpoint, so the backward gathers them
    again (FSDP); ``prefix`` is the stacked tree's path ("blocks",
    "encoder/blocks") that names their shardings. ``seq`` (a
    ``train.step.SeqPlan``; training only): between blocks, what each
    block's checkpoint keeps, x is this rank's seq block [B, ceil(S / M),
    d]; a block all-gathers it at its start, beside its weights (so the
    recompute gathers again), runs its layers on the whole sequence, and
    keeps its block of the output (:func:`_apply_layer`). After the last
    block x is gathered whole once, for the tails, the final norm and the
    loss."""
    aux = _zero_aux(x.device, aux_extras)
    decode = states is not None
    new_block_states = None
    rows = []  # per-layer aux (layer_aux)

    rec = run.shard.rec if run.shard is not None and decode else None

    def layer(p, spec, x, st, name, memory, seq=None):
        """One layer on its decode state ``st`` (None without one), whose
        new recurrent state is written back into ``st``'s tensors: whole,
        or on the serving mesh this rank's blocks (``rec``)."""
        st_in = rec.read(name, st) if rec is not None and st else st
        x, ns, a = _apply_layer(p, cfg, run, spec, x, positions, st_in,
                                cache_index, page_table, layer_override,
                                moe_override, attend_to_cache, memory, seq)
        if st is not None:
            if rec is not None:
                rec.write(name, st, ns)
            else:
                _write_recurrent(st, ns)
        return x, a

    S = x.shape[1]
    last = len(pattern) - 1

    def one_block(x, layer_params, layer_states, memory):
        if run.shard is not None:
            layer_params = run.shard.gather_layer(layer_params, prefix)
        if seq is not None:
            x = seq.gather(x, S)
        a = _zero_aux(x.device, aux_extras)
        for pos, spec in enumerate(pattern):
            key = f"pos{pos}"
            x, la = layer(layer_params[key], spec, x,
                          layer_states[key] if decode else None,
                          f"{prefix}/{key}", memory,
                          seq if pos == last else None)
            a = _acc_aux(a, la)
        return x, a

    if blocks is not None:
        if seq is not None:
            x = seq.take(x)
        block_states = states["blocks"] if decode else None
        n = next(iter(flatten(blocks).values())).shape[0]
        layer_params = _unbind_layers(blocks, n)
        layer_states = (_unbind_layers(block_states, n) if decode
                        else [None] * n)
        remat = "none" if decode else run.remat
        for lp, ls in zip(layer_params, layer_states):
            if remat == "full":
                x, a = checkpoint(one_block, x, lp, ls, memory,
                                  use_reentrant=False)
            elif remat == "dots":
                x, a = checkpoint(one_block, x, lp, ls, memory,
                                  use_reentrant=False,
                                  context_fn=modules.dots_context)
            else:
                x, a = one_block(x, lp, ls, memory)
            aux = _acc_aux(aux, a)
            rows.append(a)
        new_block_states = block_states
        if seq is not None:
            x = seq.gather(x, S)

    new_tail_states = []
    for i, (spec, tp) in enumerate(tails):
        st = tail_states[i] if tail_states else None
        x, a = layer(tp, spec, x, st, f"tails/{i}", memory)
        aux = _acc_aux(aux, a)
        rows.append(_acc_aux(_zero_aux(x.device, aux_extras), a))
        new_tail_states.append(st)

    new_states = None
    if decode:
        new_states = {"blocks": new_block_states, "tails": new_tail_states}
    if layer_aux and rows:
        aux = dict(aux, per_layer={k: torch.stack([r[k] for r in rows])
                                   for k in aux})
    return x, new_states, aux


def zero_fronts(cfg: ModelConfig, batch: int, dtype, device="cpu") -> dict:
    """The drivers' stub front embeddings, zeros in ``dtype`` (the JAX
    drivers' launch/train.py:127-136 and launch/serve.py:141-148):
    ``encoder_embeds`` [batch, encoder_seq, d] for an encoder-decoder
    arch, ``vision_embeds`` [batch, vision_seq, vision_dim] for a vision
    arch, nothing for a decoder-only one (``configs.inputs.front_specs``)."""
    from repro_torch.configs.inputs import front_specs
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in front_specs(cfg, batch, dtype).items()}


def cross_memory(params, cfg: ModelConfig, run: RunConfig, B: int,
                 encoder_embeds, vision_embeds):
    """The cross-attention memory (encoder_out [B, T, d], positions
    [B, T]) of the JAX package's stack.py:277-302, or None for a
    decoder-only arch.
    whisper: the front embeddings plus the decoder's own learned position
    rows 0..T-1, the encoder stack (bidirectional, under the run's remat),
    ``final_norm``; vision: the patch embeddings times ``vision_proj`` in
    the compute dtype, at positions 0..T-1."""
    pol = run.policy
    cd = pol.compute_dtype
    if cfg.is_encdec:
        if encoder_embeds is None:
            raise ValueError(f"{cfg.name} needs encoder_embeds")
        T = encoder_embeds.shape[1]
        enc_pos = torch.arange(T, dtype=torch.int32,
                               device=encoder_embeds.device).expand(B, T)
        enc_x = encoder_embeds.to(cd)
        if "pos" in params["embed"]:
            enc_x = enc_x + params["embed"]["pos"][:T].to(cd)[None]
        enc = params["encoder"]
        enc_x, _, _ = _apply_stack(enc["blocks"], [], cfg, run,
                                   (ENCODER_SPEC,), enc_x, enc_pos,
                                   prefix="encoder/blocks")
        return modules.apply_norm(enc["final_norm"], enc_x, pol), enc_pos
    if cfg.vision_seq > 0:
        if vision_embeds is None:
            raise ValueError(f"{cfg.name} needs vision_embeds")
        mem = vision_embeds.to(cd) @ params["vision_proj"].to(cd)
        T = mem.shape[1]
        return mem, torch.arange(T, dtype=torch.int32,
                                 device=mem.device).expand(B, T)
    return None


def apply_model(params, cfg: ModelConfig, run: RunConfig, tokens,
                positions=None, *, decode_state=None, cache_index=None,
                encoder_embeds=None, vision_embeds=None,
                return_hidden: bool = False, page_table=None,
                layer_override: Optional[Callable] = None,
                moe_override: Optional[Callable] = None,
                attend_to_cache: bool = False, aux_extras=(),
                layer_aux: bool = False):
    """Forward pass.

    tokens: [B, S] int. positions: [B, S] (default arange, or offset by
    cache_index: a scalar for lockstep decode and chunked prefill, a [B]
    vector for per-slot decode). decode_state: the dense per-slot caches
    (init_decode_state), or with page_table [B, max_pages] the paged pools
    (init_paged_decode_state); either is updated in place.
    attend_to_cache: an S > 1 prefill attends over the existing cache
    instead of assuming it empty (chunked prefill, dense mode).
    encoder_embeds [B, T_enc, d] (whisper's stub audio front) or
    vision_embeds [B, vision_seq, vision_dim] (the stub patch embeddings):
    the cross-attention memory is built from them at every call, prefill
    and each decode step alike, as the reference builds it.
    layer_override(layer_params, spec, x, positions) -> (y, aux) replaces
    every MoE layer when there is no decode state (zebra parallelism);
    moe_override(ffn_params, u) -> (f, aux) replaces the MoE FFN of every
    MoE layer (the lockstep server's and EP decode's expert-parallel MoE).
    aux_extras / layer_aux: extra fixed-shape aux keys summed over the
    layers, and with layer_aux also stacked per layer under
    ``aux["per_layer"]`` (see ``_apply_stack``; EP decode's histograms).

    Returns (logits [B, S, vocab] f32, new_decode_state, aux)."""
    B, S = tokens.shape
    dev = tokens.device
    if positions is None:
        steps = torch.arange(S, dtype=torch.int32, device=dev)
        if cache_index is not None:
            ci = torch.as_tensor(cache_index, dtype=torch.int32, device=dev)
            base = ci[:, None] if ci.dim() == 1 else ci
            positions = (base + steps).expand(B, S)
        else:
            positions = steps.expand(B, S)

    memory = cross_memory(params, cfg, run, B, encoder_embeds,
                          vision_embeds)
    sh = run.shard
    x = modules.apply_embedding(params["embed"], cfg, run.policy, tokens,
                                positions,
                                vocab=sh.vocab if sh is not None else None)
    tails = [(spec, params[f"tail{i}"])
             for i, spec in enumerate(cfg.tail_specs)]
    tail_states = decode_state["tails"] if decode_state is not None else None
    seq = None
    if sh is not None:
        seq = sh.seq if decode_state is None else sh.seq_for(S)
    x, new_state, aux = _apply_stack(
        params.get("blocks"), tails, cfg, run, cfg.pattern, x, positions,
        states=decode_state, tail_states=tail_states,
        cache_index=cache_index, page_table=page_table,
        layer_override=layer_override, moe_override=moe_override,
        attend_to_cache=attend_to_cache, aux_extras=aux_extras,
        layer_aux=layer_aux, memory=memory, seq=seq)

    x = modules.apply_norm(params["final_norm"], x, run.policy)
    if return_hidden:
        return x, new_state, aux
    return unembed(params, cfg, run, x), new_state, aux


def unembed(params, cfg: ModelConfig, run: RunConfig, x):
    """The logits [..., vocab] (accum dtype) of hidden states x [..., d]:
    on the serving mesh (``run.shard.vocab``) this rank's block of the
    vocabulary, all-gathered over "model" (only the positions given: a
    step unembeds the positions it samples)."""
    return modules.apply_unembedding(
        params["embed"], params.get("lm_head"), cfg, run.policy, x,
        vocab=run.shard.vocab if run.shard is not None else None)


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------

def _stacked_state(cfg: ModelConfig, one_layer):
    n = cfg.n_pattern_repeats
    state = {"blocks": None}
    if n > 0:
        state["blocks"] = {
            f"pos{p}": tree_map(
                lambda t: t[None].expand(n, *t.shape).contiguous(),
                one_layer(spec))
            for p, spec in enumerate(cfg.pattern)}
    state["tails"] = [one_layer(spec) for spec in cfg.tail_specs]
    return state


def state_leaves(tree, prefix: str = "") -> dict:
    """{name: leaf} of a decode-state tree, named as the JAX package's
    ``tree_map_with_path_names`` names them ("blocks/pos0/kv/k",
    "tails/0/kv/pos"; a None subtree has no leaves)."""
    if tree is None:
        return {}
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(state_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _blocks(tree, block, device, name: str = ""):
    """A decode-state tree (on the meta device) allocated as blocks:
    each leaf of shape ``block(name, shape)`` on ``device``, filled as the
    init fills it (-1 for the cache positions, 0 elsewhere)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _blocks(v, block, device, f"{name}/{k}" if name else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_blocks(v, block, device, f"{name}/{i}")
                for i, v in enumerate(tree)]
    fill = -1 if name.rsplit("/", 1)[-1] == "pos" else 0
    return torch.full(block(name, tuple(tree.shape)), fill, dtype=tree.dtype,
                      device=device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device="cpu", block=None):
    """Stacked per-layer decode state (dense per-slot cache layout).
    ``block(name, shape) -> shape`` (a rank of the serving mesh:
    ``sharding.rules.local_shape`` of the leaf's spec) allocates only that
    block of each leaf."""
    def make(dev):
        return _stacked_state(cfg, lambda spec: modules.init_layer_state(
            cfg, spec, batch, max_len, dtype, dev))
    return make(device) if block is None else \
        _blocks(make("meta"), block, device)


def init_paged_decode_state(cfg: ModelConfig, batch: int, n_pages: int,
                            page_size: int, dtype, device="cpu", block=None):
    """Paged decode state (DESIGN.md §9): per-layer KV pools of ``n_pages``
    shared physical pages (no batch dim), stacked as ``[L, P, ps, KH, hd]``
    so each layer's pool is one contiguous view. ``block``: as in
    :func:`init_decode_state`."""
    def make(dev):
        return _stacked_state(cfg, lambda spec: modules.init_paged_layer_state(
            cfg, spec, batch, n_pages, page_size, dtype, dev))
    return make(device) if block is None else \
        _blocks(make("meta"), block, device)


# -- paged-state tree surgery (engine helpers, DESIGN.md §9.4) --------------
#
# The paged engine splits a decode-state tree into its pooled-KV part
# (shared pages, written by prefill AND decode) and its per-slot recurrent
# part. Layer dicts are keyed "kv" / "rglru" / "ssd", so the split is a key
# partition applied layer-wise. (Attention-only models carry an empty
# recurrent part, mamba2 an empty KV part.)

def map_layer_states(state, fn):
    """Apply ``fn`` to every per-layer state dict of a decode-state tree."""
    out = {"blocks": None, "tails": [fn(s) for s in state["tails"]]}
    if state["blocks"] is not None:
        out["blocks"] = {k: fn(v) for k, v in state["blocks"].items()}
    return out


def split_kv_state(state):
    """(kv_tree, rec_tree): pooled attention caches vs per-slot recurrent
    states, both keeping the full blocks/tails skeleton."""
    kv = map_layer_states(
        state, lambda d: {k: v for k, v in d.items() if k == "kv"})
    rec = map_layer_states(
        state, lambda d: {k: v for k, v in d.items() if k != "kv"})
    return kv, rec


def merge_kv_state(kv_tree, rec_tree):
    """Inverse of :func:`split_kv_state` (layer-wise dict union)."""
    out = {"blocks": None,
           "tails": [{**a, **b} for a, b in zip(kv_tree["tails"],
                                                rec_tree["tails"])]}
    if kv_tree["blocks"] is not None:
        out["blocks"] = {k: {**kv_tree["blocks"][k], **rec_tree["blocks"][k]}
                         for k in kv_tree["blocks"]}
    return out


# -- page-granular pool surgery (disaggregated handoff, DESIGN.md §10) ------
#
# The KV handoff between device groups ships a request's ALLOCATED physical
# pages and nothing else: gather pulls exactly the page ids named by the
# source page table out of every layer's pool (a page-dim index_select: the
# payload keeps the [n, page_size, ...] page layout, never a contiguous
# [tokens, ...] cache), and scatter lands them at the destination pool's
# imported page ids. Block leaves carry the stacked layer dim in front of
# the page dim, so the page axis is 1 there and 0 on tails.

def _host_ids(page_ids) -> np.ndarray:
    if isinstance(page_ids, torch.Tensor):
        page_ids = page_ids.cpu()
    return np.asarray(page_ids, np.int64).reshape(-1)


def gather_kv_pages(state, page_ids, pool=None):
    """Pull physical pages ``page_ids`` of every attention layer's pool out
    of a PAGED decode-state tree. Returns the kv skeleton with the page dim
    replaced by ``len(page_ids)`` (new tensors): the transfer payload.

    ``pool`` (``serve.mesh.PoolShard``: this rank's block of a pool split
    by page over the ranks of ``pool.group``): each rank takes the pages
    it owns, and the blocks are all-gathered and each page taken from its
    owner, so every rank holds the same payload (the JAX package's
    replicated ``transfer_payload_spec``)."""
    kv, _ = split_kv_state(state)
    ids = _host_ids(page_ids)

    def take(axis):
        if pool is not None:
            return _take_owned(axis, ids, pool)
        return lambda v: v.index_select(
            axis, torch.as_tensor(ids, device=v.device))

    out = {"blocks": None,
           "tails": [tree_map(take(0), d) for d in kv["tails"]]}
    if kv["blocks"] is not None:
        out["blocks"] = {k: tree_map(take(1), v)
                         for k, v in kv["blocks"].items()}
    return out


def _take_owned(axis: int, ids, pool):
    """``take`` of :func:`gather_kv_pages` on a pool split by page."""
    per = pool.pages // pool.size
    owner = np.clip(ids // per, 0, pool.size - 1)
    local = np.where(owner == pool.rank, ids - owner * per, 0)

    def f(v):
        part = v.index_select(axis, torch.as_tensor(local, device=v.device))
        g = C.gather_nograd(part[None].contiguous(), 0, pool.group)
        g = g.movedim(axis + 1, 1)   # [ranks, n, ...]
        sel = g[torch.as_tensor(owner, device=v.device),
                torch.arange(len(ids), device=v.device)]
        return sel.movedim(0, axis).contiguous()
    return f


def scatter_kv_pages(state, payload, page_ids, pool=None):
    """Write a :func:`gather_kv_pages` payload into the pool pages
    ``page_ids`` of a PAGED decode-state tree, IN PLACE (the import half of
    the handoff). Out-of-range ids (the transfer engine's chunk-padding
    sentinel) are dropped: their rows are masked out on the host before
    the write, as the JAX package's ``mode="drop"`` drops them (an
    out-of-range index write on a CUDA tensor is a device-side assert);
    ids in [-n, 0) count from the end, as there. With ``pool`` (see
    :func:`gather_kv_pages`) each rank writes the pages it owns. Returns
    ``state``."""
    kv, _ = split_kv_state(state)
    ids = _host_ids(page_ids)

    def put(axis):
        def f(dst, src):
            n = dst.shape[axis]
            lo = 0
            if pool is not None:
                n, lo = pool.pages, pool.rank * (pool.pages // pool.size)
            ids_n = np.where(ids < 0, ids + n, ids)
            keep = np.nonzero((ids_n >= lo)
                              & (ids_n < lo + dst.shape[axis]))[0]
            if len(keep) == 0:
                return
            if len(keep) < len(ids):
                src = src.index_select(
                    axis, torch.as_tensor(keep, device=src.device))
            dst.index_copy_(axis, torch.as_tensor(ids_n[keep] - lo,
                                                  device=dst.device),
                            src.to(dst.dtype))
        return f

    for d, p in zip(kv["tails"], payload["tails"]):
        _tree_zip(put(0), d, p)
    if kv["blocks"] is not None:
        for k in kv["blocks"]:
            _tree_zip(put(1), kv["blocks"][k], payload["blocks"][k])
    return state


def _tree_zip(fn, dst, src) -> None:
    """``fn(dst_leaf, src_leaf)`` over two dict trees of one structure."""
    for k, d in dst.items():
        if isinstance(d, dict):
            _tree_zip(fn, d, src[k])
        else:
            fn(d, src[k])
