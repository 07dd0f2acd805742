"""What the training and serving meshes run at, measured while they run
(a port addition, no counterpart in the JAX package). Training
(:func:`mesh_census`): the residual-stream input that each stacked
block's checkpoint keeps for the backward, and the heads of each
attention call. Serving (:func:`serve_census`): the blocks over "model"
each call computes with, and the weight bytes each step gathers. Off
unless a census is entered; each wraps the functions it reads for its
duration."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def mesh_census():
    """Yields {"kept": [[shape, bytes of its storage], ...] of the block
    input each ``stack.checkpoint`` call saves (seen by a saved-tensor
    hook around the call: the checkpoint's own saved inputs, so a view
    that holds a larger storage alive shows its storage's bytes), "attn":
    [[q heads, kv heads], ...] of each attention call}, filled as the
    program runs inside the context."""
    from repro_torch.models import modules, stack
    real_ckpt, real_inner = stack.checkpoint, modules._attention_inner
    rec = {"kept": [], "attn": []}

    def ckpt(fn, x, *args, **kw):
        saved = []

        def pack(t):
            saved.append(t)
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = real_ckpt(fn, x, *args, **kw)
        rec["kept"] += [[list(t.shape), t.untyped_storage().nbytes()]
                        for t in saved if t.data_ptr() == x.data_ptr()
                        and t.shape == x.shape]
        return out

    def inner(q, k, v, *args, **kw):
        rec["attn"].append([q.shape[2], k.shape[2]])
        return real_inner(q, k, v, *args, **kw)

    stack.checkpoint, modules._attention_inner = ckpt, inner
    try:
        yield rec
    finally:
        stack.checkpoint, modules._attention_inner = real_ckpt, real_inner


@contextlib.contextmanager
def serve_census():
    """Yields {"attn": [[q heads, kv heads], ...] of each attention
    projection, "ffn": [width, ...] of each dense FFN, "ffn_sums":
    [collectives, ...] each dense FFN launched (its partial product's sum
    over "model": 1 where its width is split, else 0), "rglru":
    [channels, ...] of each RG-LRU mixer, "ssd": [heads, ...] of each SSD
    mixer, "vocab": [columns, ...] of each unembedding's block before
    its gather, "weights": [bytes, ...] of the weights each step runs on
    after its gathers (one entry per ``ServeLayout.gather_params``, the
    step's stacked layers' ``ShardContext.gather_layer`` added to it)},
    filled as the serving programs run inside the context."""
    from repro_torch.models import modules
    from repro_torch.serve.mesh import ServeLayout
    from repro_torch.sharding import collectives as C
    from repro_torch.train.step import ShardContext
    rec = {"attn": [], "ffn": [], "ffn_sums": [], "rglru": [], "ssd": [],
           "vocab": [], "weights": []}
    real = {"qkv": modules._project_qkv, "mlp": modules.apply_mlp,
            "rglru": modules.apply_rglru, "ssd": modules.apply_ssd,
            "vocab": modules.unembed_block,
            "params": ServeLayout.gather_params,
            "layer": ShardContext.gather_layer}

    def nbytes(tree):
        return sum(nbytes(v) if isinstance(v, dict) else
                   v.numel() * v.element_size() for v in tree.values())

    def qkv(params, cfg, *args, **kw):
        out = real["qkv"](params, cfg, *args, **kw)
        rec["attn"].append([out[0].shape[2], out[1].shape[2]])
        return out

    def mlp(params, *args, **kw):
        rec["ffn"].append(params["wo"].shape[0])
        before = sum(C.COUNTS.values())
        out = real["mlp"](params, *args, **kw)
        rec["ffn_sums"].append(sum(C.COUNTS.values()) - before)
        return out

    def rglru(params, *args, **kw):
        rec["rglru"].append(params["proj_rec"].shape[-1])
        return real["rglru"](params, *args, **kw)

    def ssd(params, cfg, run, x, state=None):
        tp = state.get("tp") if state is not None else None
        rec["ssd"].append(tp[1] - tp[0] if tp else cfg.ssm_heads)
        return real["ssd"](params, cfg, run, x, state)

    def vocab(*args, **kw):
        out = real["vocab"](*args, **kw)
        rec["vocab"].append(out.shape[-1])
        return out

    def params(self, tree):
        out = real["params"](self, tree)
        rec["weights"].append(nbytes(
            {k: v for k, v in out.items() if k != "blocks"}))
        enc = out.get("encoder", {})
        if "blocks" in enc:  # the encoder's layers gather per layer
            rec["weights"][-1] -= nbytes(enc["blocks"])
        return out

    def layer(self, tree, prefix):
        out = real["layer"](self, tree, prefix)
        if rec["weights"]:
            rec["weights"][-1] += nbytes(out)
        return out

    modules._project_qkv, modules.apply_mlp = qkv, mlp
    modules.apply_rglru, modules.apply_ssd = rglru, ssd
    modules.unembed_block = vocab
    ServeLayout.gather_params, ShardContext.gather_layer = params, layer
    try:
        yield rec
    finally:
        modules._project_qkv, modules.apply_mlp = real["qkv"], real["mlp"]
        modules.apply_rglru, modules.apply_ssd = real["rglru"], real["ssd"]
        modules.unembed_block = real["vocab"]
        ServeLayout.gather_params = real["params"]
        ShardContext.gather_layer = real["layer"]
