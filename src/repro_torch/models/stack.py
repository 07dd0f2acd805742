"""Model assembly: embedding -> stacked block loop -> head (mirror of
``repro/models/stack.py``).

Params keep the JAX package's stacked layout: the layer ``pattern`` repeated
``n_pattern_repeats`` times is one tree per pattern position
(``blocks/pos{i}/...``) whose leaves carry a leading layer axis, plus
unrolled ``tail{i}`` layers. ``_apply_stack`` is a Python loop over that
axis (the JAX package's ``lax.scan``). Decode states use the same stacked
layout, so one layer's KV pool ``[P, ps, KH, hd]`` is a contiguous view of
the ``[L, P, ps, KH, hd]`` leaf that the kernels read and that the paged
attention updates in place.

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
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import modules
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import ParamSpec, flatten, materialize, tree_map

AUX_KEYS = ("moe_aux_loss", "moe_z_loss")

# Leaves cast to the compute dtype at their use in the JAX package
# (``.astype(cd)``; the SSD conv taps and bias are cast to x's dtype, the
# compute dtype, inside ``causal_conv1d``). Norm scales and the router stay
# f32: they are used in the accum dtype; so do the SSD's dt_bias, A_log and
# norm, and its D, which is cast at its use from f32.
_COMPUTE_LEAVES = ("table", "lm_head", "wq", "wk", "wv", "wo", "wi_gate",
                   "wi_up", "wi", "in_proj", "out_proj", "conv_w", "conv_b")


def _zero_aux(device):
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def _acc_aux(acc, aux):
    return {k: acc[k] + aux[k].float() if k in aux else acc[k] for k in acc}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig):
    """The parameter tree as ParamSpecs (shape + initializer), in the JAX
    package's ``split_params`` layout."""
    if cfg.is_encdec or cfg.vision_seq > 0:
        raise NotImplementedError("encoder-decoder and vision models are "
                                  "not ported yet")
    specs = {"embed": modules.init_embedding(cfg)}
    n = cfg.n_pattern_repeats
    if n > 0:
        specs["blocks"] = {
            f"pos{p}": tree_map(lambda s: s.stacked(n),
                                modules.init_layer(cfg, spec))
            for p, spec in enumerate(cfg.pattern)}
    for i, spec in enumerate(cfg.tail_specs):
        specs[f"tail{i}"] = modules.init_layer(cfg, spec)
    specs["final_norm"] = modules.init_norm(cfg)
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                                     fan_in=cfg.d_model)
    return specs


def flat_param_specs(cfg: ModelConfig) -> dict:
    """{'blocks/pos0/mixer/wq': ParamSpec, ...}"""
    return flatten(param_specs(cfg))


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

def _unbind_layers(tree):
    """Per-layer views of a stacked tree: a list over the leading layer
    axis of trees of the same structure. ``unbind`` (not ``v[i]`` per
    layer) gives autograd one node per stacked leaf, whose backward stacks
    the layer gradients once instead of summing one full-size zero-padded
    gradient per layer."""
    if isinstance(tree, dict):
        subs = {k: _unbind_layers(v) for k, v in tree.items()}
        n = len(next(iter(subs.values())))
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return tree.unbind(0)


def _apply_layer(p, cfg, run, spec, x, positions, state, cache_index,
                 page_table, layer_override):
    """One layer: ``layer_override`` (zebra) for a MoE layer without decode
    state, else ``modules.apply_layer``. Returns (x, new_state, aux)."""
    if layer_override is not None and spec.ffn == "moe" and state is None:
        y, aux = layer_override(p, spec, x, positions)
        return y, None, aux
    return modules.apply_layer(p, cfg, run, spec, x, positions, state=state,
                               cache_index=cache_index, page_table=page_table)


def _apply_stack(blocks, tails, cfg: ModelConfig, run: RunConfig, pattern,
                 x, positions, states=None, tail_states=None,
                 cache_index=None, page_table=None,
                 layer_override: Optional[Callable] = None):
    """Run the stacked pattern layers + tail. Returns (x, new_states, aux).

    Block states are per-layer views of the stacked leaves and are updated
    in place, so ``new_states`` holds the same tensors as ``states``.
    Without states and with ``run.remat`` "full" or "dots" each repeat of
    the pattern is one checkpoint (recomputed in the backward, the
    ``layer_override`` with it; under "dots" but for the products that
    ``modules.dots_with_no_batch_dims_saveable`` saves)."""
    aux = _zero_aux(x.device)
    decode = states is not None
    new_block_states = None

    def one_block(x, layer_params, layer_states):
        a = _zero_aux(x.device)
        for pos, spec in enumerate(pattern):
            key = f"pos{pos}"
            st = layer_states[key] if decode else None
            x, _, la = _apply_layer(layer_params[key], cfg, run, spec, x,
                                    positions, st, cache_index, page_table,
                                    layer_override)
            a = _acc_aux(a, la)
        return x, a

    if blocks is not None:
        block_states = states["blocks"] if decode else None
        layer_params = _unbind_layers(blocks)
        layer_states = (_unbind_layers(block_states) if decode
                        else [None] * len(layer_params))
        remat = "none" if decode else run.remat
        for lp, ls in zip(layer_params, layer_states):
            if remat == "full":
                x, a = checkpoint(one_block, x, lp, ls, use_reentrant=False)
            elif remat == "dots":
                x, a = checkpoint(one_block, x, lp, ls, use_reentrant=False,
                                  context_fn=modules.dots_context)
            else:
                x, a = one_block(x, lp, ls)
            aux = _acc_aux(aux, a)
        new_block_states = block_states

    new_tail_states = []
    for i, (spec, tp) in enumerate(tails):
        st = tail_states[i] if tail_states else None
        x, ns, a = _apply_layer(tp, cfg, run, spec, x, positions, st,
                                cache_index, page_table, layer_override)
        aux = _acc_aux(aux, a)
        new_tail_states.append(ns)

    new_states = None
    if decode:
        new_states = {"blocks": new_block_states, "tails": new_tail_states}
    return x, new_states, aux


def apply_model(params, cfg: ModelConfig, run: RunConfig, tokens,
                positions=None, *, decode_state=None, cache_index=None,
                return_hidden: bool = False, page_table=None,
                layer_override: Optional[Callable] = None):
    """Forward pass.

    tokens: [B, S] int. positions: [B, S] (default arange, or offset by
    cache_index: a scalar for chunked prefill, a [B] vector for per-slot
    decode). decode_state + page_table [B, max_pages]: paged-KV mode
    (state from init_paged_decode_state, pools updated in place).
    layer_override(layer_params, spec, x, positions) -> (y, aux) replaces
    every MoE layer when there is no decode state (zebra parallelism).

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

    x = modules.apply_embedding(params["embed"], cfg, run.policy, tokens)
    tails = [(spec, params[f"tail{i}"])
             for i, spec in enumerate(cfg.tail_specs)]
    tail_states = decode_state["tails"] if decode_state is not None else None
    x, new_state, aux = _apply_stack(
        params.get("blocks"), tails, cfg, run, cfg.pattern, x, positions,
        states=decode_state, tail_states=tail_states,
        cache_index=cache_index, page_table=page_table,
        layer_override=layer_override)

    x = modules.apply_norm(params["final_norm"], x, run.policy)
    if return_hidden:
        return x, new_state, aux
    logits = modules.apply_unembedding(params["embed"], params.get("lm_head"),
                                       cfg, run.policy, x)
    return logits, new_state, aux


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


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device="cpu"):
    """Stacked per-layer decode state (dense per-slot cache layout)."""
    return _stacked_state(cfg, lambda spec: modules.init_layer_state(
        cfg, spec, batch, max_len, dtype, device))


def init_paged_decode_state(cfg: ModelConfig, batch: int, n_pages: int,
                            page_size: int, dtype, device="cpu"):
    """Paged decode state (DESIGN.md §9): per-layer KV pools of ``n_pages``
    shared physical pages (no batch dim), stacked as ``[L, P, ps, KH, hd]``
    so each layer's pool is one contiguous view."""
    return _stacked_state(cfg, lambda spec: modules.init_paged_layer_state(
        cfg, spec, batch, n_pages, page_size, dtype, device))


# -- paged-state tree surgery (engine helpers, DESIGN.md §9.4) --------------
#
# The paged engine splits a decode-state tree into its pooled-KV part
# (shared pages, written by prefill AND decode) and its per-slot recurrent
# part. Layer dicts are keyed "kv" / "rglru" / "ssd", so the split is a key
# partition applied layer-wise. (Attention-only models carry an empty
# recurrent part; the split keeps the engine's structure for the recurrent
# mixers of a later slice.)

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
