"""Losses: causal-LM cross entropy (+ z-loss) and the MoE aux terms (mirror
of ``repro/train/loss.py``)."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def cross_entropy(logits, targets, z_loss_coef: float = 1e-4, mask=None):
    """logits: [..., V] (f32 recommended); targets: [...] int.

    Returns (loss, metrics). The z-loss regularizes logsumexp drift."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    zl = lse.square()
    if mask is not None:
        mask = mask.to(nll.dtype)
        denom = mask.sum().clamp(min=1.0)
        nll = (nll * mask).sum() / denom
        zl = (zl * mask).sum() / denom
    else:
        nll = nll.mean()
        zl = zl.mean()
    loss = nll + z_loss_coef * zl
    return loss, {"nll": nll, "z_loss": zl}


def total_loss(logits, targets, aux, z_loss_coef: float = 1e-4, mask=None):
    """LM loss + MoE auxiliary losses (already coefficient-scaled)."""
    loss, metrics = cross_entropy(logits, targets, z_loss_coef, mask)
    loss = loss + aux.get("moe_aux_loss", 0.0) + aux.get("moe_z_loss", 0.0)
    metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


def chunked_xent_from_hidden(hidden, table, targets, *, chunk: int = 512,
                             z_loss_coef: float = 1e-4,
                             accum_dtype=torch.float32):
    """Cross entropy streamed over sequence chunks, never materializing the
    full [B, S, V] f32 logits.

    hidden: [B, S, d]; table: [V, d] (lm head or tied embedding, in the
    compute dtype). Each chunk is checkpointed, so the backward recomputes
    its logits (the JAX package's ``jax.checkpoint``). The logits are f32
    sums of the compute-dtype operands (``preferred_element_type``): both
    operands are widened to f32 first, which gives the same exact products
    (a bf16 matmul would round the logits)."""
    B, S, d = hidden.shape
    c = min(chunk, S)
    pad = (-S) % c
    valid = torch.ones((B, S), dtype=torch.bool, device=hidden.device)
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    n = (S + pad) // c

    def block(h, tab, t, v):
        logits = h.to(accum_dtype) @ tab.to(accum_dtype).T
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, t.long()[..., None])[..., 0]
        zero = torch.zeros((), dtype=accum_dtype, device=h.device)
        return (torch.where(v, lse - gold, zero).sum(),
                torch.where(v, lse.square(), zero).sum())

    nll = torch.zeros((), dtype=accum_dtype, device=hidden.device)
    zl = torch.zeros((), dtype=accum_dtype, device=hidden.device)
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        a, b = checkpoint(block, hidden[:, sl], table, targets[:, sl],
                          valid[:, sl], use_reentrant=False)
        nll = nll + a
        zl = zl + b
    denom = B * S
    nll = nll / denom
    zl = zl / denom
    return nll + z_loss_coef * zl, {"nll": nll, "z_loss": zl}
