"""Training step builder, one device, no mesh (mirror of
``repro/train/step.py``).

:class:`TrainProgram` is the object the launcher, ``chip_smoke.py`` and the
tests share: the model config, the run policy, the optimizer config and
the step functions. Zebra parallelism (``zcfg``) runs through the layer
override of ``core/zebra_spmd.py``, on one process (one EP rank).
Gradient accumulation (``accum_steps``) sums the f32 gradients of batch
slices before one AdamW update, as the JAX package's scan does. The JAX
package's meshes, shardings and gradient-sharding constraints are not
ported yet; :func:`make_train_program` refuses them by name.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import zebra_spmd
from repro_torch.models import stack
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.modules import RunConfig
from repro_torch.pytree import flatten
from repro_torch.train import optimizer as opt
from repro_torch.train.loss import chunked_xent_from_hidden


@dataclasses.dataclass
class TrainProgram:
    cfg: ModelConfig
    run: RunConfig
    opt_cfg: opt.OptimizerConfig
    device: torch.device
    train_step: Callable  # (params, opt, batch) -> (params, opt, metrics)
    grad_fn: Callable     # (params, batch) -> (grads, metrics)
    loss_fn: Callable     # (params, batch) -> (loss, metrics)
    zcfg: Optional[zebra_spmd.ZebraConfig] = None  # as fitted

    def init_params(self, seed: int = 0):
        """Seeded params on the program's device, in the policy's param
        dtype (the JAX package's init cannot be reproduced; parity tests
        bring its weights in through ``pytree.params_from_jax``)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = stack.init_model(gen, self.cfg, device=self.device)
        pd = self.run.policy.param_dtype
        if pd != torch.float32:
            params = _cast_tree(params, pd)
        return params

    @property
    def master_weights(self) -> bool:
        return self.run.policy.param_dtype != torch.float32

    def init_opt(self, params):
        return opt.init_opt_state(params, master_weights=self.master_weights)


def _cast_tree(tree, dtype):
    return {k: _cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def fit_zebra(zcfg: zebra_spmd.ZebraConfig, cfg: ModelConfig,
              global_batch: int) -> zebra_spmd.ZebraConfig:
    """``zcfg`` fitted to the run (the JAX package's
    ``make_train_program``, step.py:101-120, on one process: one batch
    shard, one EP rank): the microbatch count lowered until it divides the
    batch; in alltoall mode the offload clamped to [0, E - 1] and at least
    one dispatch chunk."""
    R, B = zcfg.num_microbatches, global_batch
    while R > 1 and B % R:
        R -= 1
    zcfg = dataclasses.replace(zcfg, num_microbatches=R)
    if cfg.is_moe and zcfg.mode == "alltoall":
        off = max(min(zcfg.offload_experts, cfg.n_experts - 1), 0)
        zcfg = dataclasses.replace(zcfg, offload_experts=off,
                                   n_chunks=max(int(zcfg.n_chunks), 1))
    return zcfg


def make_train_program(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig,
                       opt_cfg: Optional[opt.OptimizerConfig] = None, *,
                       device="cuda", mesh=None, zcfg=None,
                       constrain_grads: bool = False, accum_steps: int = 1,
                       zebra_streams: bool = True) -> TrainProgram:
    """The train program of ``cfg`` on one device.

    ``train_step(params, opt_state, batch)`` is ``grad_fn`` (the forward,
    with ``run.remat`` recompute, and the backward through
    ``torch.autograd.grad``; it returns the gradients by path name) and
    AdamW, which updates params and optimizer state in place; it returns
    them with the JAX package's metrics (``loss``, ``nll``, ``z_loss``,
    ``moe_aux_loss``, ``moe_z_loss``, ``grad_norm``, ``lr``) as 0-dim
    tensors on the device. ``batch`` holds ``tokens`` and ``targets``
    [B, S] on any device; they are moved to the program's device.
    ``shape``'s global batch fits the zebra config (:func:`fit_zebra`); the
    step itself reads its batch's own shape.

    ``zcfg``: zebra parallelism for MoE archs, the fitted config's layer
    override (``zebra_spmd.make_layer_override``) in place of every MoE
    layer. ``zebra_streams=False`` runs the override's two halves on one
    CUDA stream (a test's reference for the two-stream schedule).

    ``accum_steps > 1`` (the JAX package's step.py:161-186): the batch is
    cut along dim 0 into ``accum_steps`` slices, ``grad_fn`` runs on each
    in turn, the f32 gradients are summed and divided by ``accum_steps``,
    the loss and every metric averaged over the slices; then one AdamW
    update. The zebra config is fitted on the global batch, as the JAX
    package fits it; the override fits its microbatch count to each
    slice, as it does there. The global batch must divide by
    ``accum_steps``."""
    unported = []
    if mesh is not None:
        unported.append("mesh (one device only)")
    if constrain_grads:
        unported.append("constrain_grads")
    if unported:
        raise NotImplementedError("not ported to repro_torch yet: "
                                  + ", ".join(unported))
    if accum_steps > 1 and shape.global_batch % accum_steps:
        raise ValueError(f"global batch {shape.global_batch} does not "
                         f"divide into accum_steps={accum_steps} slices")
    opt_cfg = opt_cfg or opt.OptimizerConfig()
    device = torch.device(device)
    cd = run.policy.compute_dtype
    override = None
    if zcfg is not None:
        zcfg = fit_zebra(zcfg, cfg, shape.global_batch)
        if cfg.is_moe:
            override = zebra_spmd.make_layer_override(
                cfg, run, zcfg, streams=zebra_streams)

    def loss_fn(params, batch):
        hidden, _, aux = stack.apply_model(params, cfg, run, batch["tokens"],
                                           return_hidden=True,
                                           layer_override=override)
        table = params.get("lm_head", params["embed"]["table"])
        loss, metrics = chunked_xent_from_hidden(hidden, table.to(cd),
                                                 batch["targets"])
        loss = loss + aux.get("moe_aux_loss", 0.0) \
            + aux.get("moe_z_loss", 0.0)
        metrics = dict(metrics, **aux, loss=loss)
        return loss, metrics

    def grad_fn(params, batch):
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        leaves = flatten(params)
        for p in leaves.values():
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        finally:
            for p in leaves.values():
                p.requires_grad_(False)
        return (dict(zip(leaves, grads)),
                {k: v.detach() for k, v in metrics.items()})

    def accum_grad_fn(params, batch):
        g_sum, ms = None, []
        for i in range(accum_steps):
            g, m = grad_fn(params, {
                k: v[i * (v.shape[0] // accum_steps):
                     (i + 1) * (v.shape[0] // accum_steps)]
                for k, v in batch.items()})
            if g_sum is None:
                g_sum = {k: v.float() for k, v in g.items()}
            else:
                for k, v in g.items():
                    g_sum[k].add_(v)
            del g
            ms.append(m)
        div = torch.tensor(float(accum_steps), device=device)
        grads = {k: v.div_(div) for k, v in g_sum.items()}
        metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                   for k in ms[0]}
        return grads, metrics

    def train_step(params, opt_state, batch):
        if accum_steps > 1:
            grads, metrics = accum_grad_fn(params, batch)
        else:
            grads, metrics = grad_fn(params, batch)
        params, opt_state, om = opt.adamw_update(opt_cfg, params, grads,
                                                 opt_state)
        metrics.update(om)
        return params, opt_state, metrics

    return TrainProgram(cfg=cfg, run=run, opt_cfg=opt_cfg, device=device,
                        train_step=train_step, grad_fn=grad_fn,
                        loss_fn=loss_fn, zcfg=zcfg)
