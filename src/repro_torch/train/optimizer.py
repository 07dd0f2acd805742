"""AdamW over a dict tree of tensors (mirror of ``repro/train/optimizer.py``).

Master weights and moments are f32; compute casts to bf16 happen inside
the model (mixed precision per the paper's §6.1 setup). The JAX package
returns new trees; the port updates params and optimizer state IN PLACE
(under ``torch.no_grad()``), which keeps one copy of each on the card, and
returns the same dicts. The arithmetic follows the JAX update term by term
(clip scale, bias corrections, ``delta + wd * base`` on matrices only), so
``torch.optim.AdamW``, which orders the decay and the schedule
differently, is not used. On a mesh each rank updates its shards
(``train/step.py``'s mesh program): the norm counts every element once
over the ranks, and a replicated leaf's moments are ZeRO-1 blocks over
"data" (:func:`opt_state_axes`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.pytree import flatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_schedule(cfg: OptimizerConfig, step):
    """Linear warmup + cosine decay to end_lr_frac * peak, in f32 (a 0-dim
    tensor on ``step``'s device when ``step`` is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.peak_lr * (cfg.end_lr_frac + (1 - cfg.end_lr_frac)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, master_weights: bool = False):
    """Zero f32 moments shaped like ``params`` and a step counter (0-dim
    int32 on the params' device). master_weights: keep an f32 master copy
    so params themselves can be stored in a lower precision."""
    leaves = flatten(params)
    dev = next(iter(leaves.values())).device
    st = {
        "mu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in leaves.items()},
        "nu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in leaves.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if master_weights:
        st["master"] = {k: p.detach().float().clone()
                        for k, p in leaves.items()}
    return st


def global_norm(tensors, weights=None, reduce=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32. On a mesh
    (the mesh program's shards): ``weights`` scales each tensor's sum by
    1 / (the ranks that hold a copy of it), and ``reduce`` sums over the
    ranks, so every element of the global tree counts once."""
    if weights is None:
        sq = sum(t.float().square().sum() for t in tensors)
    else:
        sq = sum(t.float().square().sum() * w
                 for t, w in zip(tensors, weights))
    if reduce is not None:
        sq = reduce(sq)
    return torch.sqrt(sq)


def opt_state_axes(param_axes: dict, zero1_axis: Optional[str] = "zero",
                   master_weights: bool = False) -> dict:
    """Logical axes of the optimizer state (the JAX package's
    ``opt_state_axes``; ``param_axes`` is ``{path: axes}``): the params',
    but a fully replicated leaf's moments get their first dim tagged
    ``zero1_axis`` (mapped to "data" by the ZeRO-1 rules)."""
    def moment_axes(a):
        if zero1_axis and all(x is None for x in a) and len(a) >= 1:
            return (zero1_axis,) + tuple(a[1:])
        return tuple(a)
    moments = {k: moment_axes(a) for k, a in param_axes.items()}
    st = {"mu": moments, "nu": dict(moments), "step": ()}
    if master_weights:
        st["master"] = dict(moments)
    return st


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, state, *,
                 norm_weights=None, norm_reduce=None, zero1=None):
    """One AdamW step, IN PLACE: ``params`` (a dict tree of tensors) and
    ``state`` (from :func:`init_opt_state`, moments keyed by the params'
    flattened path names) are updated where they lie; ``grads`` is a dict
    {path name: gradient} (the gradients are consumed: they are scaled in
    place). Returns (params, state, metrics) with metrics
    ``grad_norm`` and ``lr``. With master weights the update applies to the
    f32 master and params receive its cast.

    On a mesh (the mesh program's shards): ``norm_weights`` ({path:
    weight}) and ``norm_reduce`` make the norm global (:func:`global_norm`),
    and ``zero1`` ({path: (take, gather)}) names the ZeRO-1 leaves: their
    moments (and master) hold this rank's block, ``take(full)`` cuts the
    gradient and the param to it, and the param is rebuilt from the
    updated blocks by ``gather``."""
    leaves = flatten(params)
    step = state["step"] + 1
    names = list(grads)
    gnorm = global_norm(
        [grads[k] for k in names],
        None if norm_weights is None else [norm_weights[k] for k in names],
        norm_reduce)
    scale = (cfg.grad_clip / (gnorm + 1e-9)).clamp(max=1.0) \
        if cfg.grad_clip > 0 else None
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    masters = state.get("master")

    for name, p in leaves.items():
        g = grads[name]
        g = g.float() if g.dtype != torch.float32 else g
        if scale is not None:
            g.mul_(scale)
        z = zero1.get(name) if zero1 else None
        if z is not None:
            g = z[0](g)
        mu, nu = state["mu"][name], state["nu"][name]
        base = masters[name] if masters is not None else \
            (z[0](p.float()) if z is not None else p.float())
        mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        nu.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        delta = (mu / b1c).div_((nu / b2c).sqrt_().add_(cfg.eps))
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta.add_(cfg.weight_decay * base)
        new_master = base - lr * delta
        del delta
        if masters is not None:
            masters[name].copy_(new_master)
        p.copy_(new_master if z is None else z[1](new_master.to(p.dtype)))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
