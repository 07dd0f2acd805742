"""What the training mesh runs at, measured while it runs (a port
addition, no counterpart in the JAX package): the residual-stream input
that each stacked block's checkpoint keeps for the backward, and the
heads of each attention call. Off unless :func:`mesh_census` is entered;
it wraps ``models.stack.checkpoint`` and
``models.modules._attention_inner`` for its duration."""

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
