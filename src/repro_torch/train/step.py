"""Training step builder (mirror of ``repro/train/step.py``): one
device, or a mesh of ranks; one device is the 1x1 mesh.

:class:`TrainProgram` is the object the launcher, ``chip_smoke.py`` and the
tests share: the model config, the run policy, the optimizer config and
the step functions. Zebra parallelism (``zcfg``) runs through the layer
override of ``core/zebra_spmd.py``. Gradient accumulation
(``accum_steps``) sums the f32 gradients of batch slices before one AdamW
update, as the JAX package's scan does.

On a mesh (``mesh=``, a ``launch.mesh.Mesh`` over D x M ranks) the program
is the JAX package's ``make_train_program`` on a DATA x MODEL mesh, run
by every rank on its shards (:func:`_mesh_program`):

* each rank holds its block of every param and optimizer leaf under the
  JAX package's fitted shardings (``sharding.rules``: 2D FSDP weights,
  experts over "model", ZeRO-1 moments of replicated leaves over "data");
* every weight is all-gathered over the mesh axes its compute does not
  shard, a stacked layer's at its block's start inside the block's
  checkpoint (so the backward gathers it again), the others at the
  forward's start (autograd-aware: the backward is the reduce-scatter),
  except the zebra expert stacks over "model" (each EP
  rank uses its own experts) and, under the "hybrid" rules, the attention
  heads and the vocabulary over "model" (Megatron tensor parallelism:
  heads split, the output projection summed over "model"; a
  vocab-parallel cross entropy);
* a rank computes on the rows of the global batch that the JAX layout
  gives its batch shard: zebra microbatch k (and accumulation slice i) is
  a global row range whose r-th block is batch shard r's;
* the loss is the global one on every rank; each rank differentiates
  1/world of it, and every collective's backward is its transpose
  (``sharding.collectives``), so after a sum over the ranks that hold a
  copy of a leaf each rank has its block of the global gradient;
* AdamW updates the blocks; the grad norm counts every element once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import zebra_spmd
from repro_torch.models import stack
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.modules import RunConfig
from repro_torch.pytree import flatten, materialize
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (MeshShape, ShardingRules,
                                        block_index, fitted_specs,
                                        local_shape, local_slice, rules_for,
                                        spec_axes)
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
    layout: Optional["MeshLayout"] = None

    def init_params(self, seed: int = 0):
        """Seeded params on the program's device, in the policy's param
        dtype (the JAX package's init cannot be reproduced; parity tests
        bring its weights in through ``pytree.params_from_jax``); on a
        mesh, this rank's block of the same values."""
        return self.layout.init_params(seed, self.device,
                                       self.run.policy.param_dtype)

    @property
    def master_weights(self) -> bool:
        return self.run.policy.param_dtype != torch.float32

    def init_opt(self, params):
        return self.layout.init_opt(params, self.master_weights)


class OneDevice(MeshShape):
    """The 1x1 mesh of a program on one device: no process group, every
    collective the identity."""

    rank = 0

    def __init__(self):
        super().__init__((1, 1), ("data", "model"))
        self.coords = {"data": 0, "model": 0}

    def group(self, axes):
        return None


def fit_batch_axes(batch: int, mesh, axes: tuple) -> tuple:
    """Largest prefix of ``axes`` whose product divides ``batch``."""
    out = []
    prod = 1
    for a in axes:
        prod *= mesh.shape[a]
        if batch % prod == 0:
            out.append(a)
        else:
            break
    return tuple(out)


def _zero1_rules(rules: ShardingRules) -> ShardingRules:
    r = dict(rules.rules)
    r["zero"] = "data"
    return dataclasses.replace(rules, rules=r)


def fit_zebra(zcfg: zebra_spmd.ZebraConfig, cfg: ModelConfig,
              global_batch: int, mesh,
              batch_axes: tuple) -> zebra_spmd.ZebraConfig:
    """``zcfg`` fitted to the run (the JAX package's
    ``make_train_program``, step.py:101-121): ``batch_axes`` becomes the
    prefix of the rules' ``batch_axes`` that divides the batch; the
    microbatch count is lowered until it divides the batch and each
    microbatch divides over the batch shards; in alltoall mode the
    offload is lowered until the remote experts divide over the EP axis,
    with at least one dispatch chunk."""
    zb = fit_batch_axes(global_batch, mesh, tuple(batch_axes))
    nsh = mesh.size_of(zb)
    n_ep = mesh.shape[zcfg.ep_axis]
    R, B = zcfg.num_microbatches, global_batch
    while R > 1 and (B % R or (B // R) % nsh):
        R -= 1
    zcfg = dataclasses.replace(zcfg, batch_axes=zb, num_microbatches=R)
    if cfg.is_moe and zcfg.mode == "alltoall":
        off = max(min(zcfg.offload_experts, cfg.n_experts - n_ep), 0)
        while off and (cfg.n_experts - off) % n_ep:
            off -= 1
        zcfg = dataclasses.replace(zcfg, offload_experts=off,
                                   n_chunks=max(int(zcfg.n_chunks), 1))
    return zcfg


def make_train_program(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig,
                       opt_cfg: Optional[opt.OptimizerConfig] = None, *,
                       device="cuda", mesh=None, zcfg=None,
                       constrain_grads: bool = False, accum_steps: int = 1,
                       zebra_streams: bool = True) -> TrainProgram:
    """The train program of ``cfg`` on one device, or on this rank of
    ``mesh``.

    ``train_step(params, opt_state, batch)`` is ``grad_fn`` (the forward,
    with ``run.remat`` recompute, and the backward through
    ``torch.autograd.grad``; it returns the gradients by path name) and
    AdamW, which updates params and optimizer state in place; it returns
    them with the JAX package's metrics (``loss``, ``nll``, ``z_loss``,
    ``moe_aux_loss``, ``moe_z_loss``, ``grad_norm``, ``lr``) as 0-dim
    tensors on the device. ``batch`` holds ``tokens`` and ``targets``
    [B, S] on any device, and the front embeddings of an encoder-decoder
    (``encoder_embeds``) or vision (``vision_embeds``) arch; they are
    moved to the program's device.
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
    ``accum_steps``.

    ``mesh`` (a ``launch.mesh.Mesh``; None: a 1x1 mesh of this device,
    :class:`OneDevice`): the mesh program (see the module docstring);
    ``train_step`` takes this rank's params and optimizer state and the
    GLOBAL batch, and returns the global metrics on every rank.
    ``constrain_grads`` (the JAX package's pin of the gradients to
    the params' shardings) changes nothing: the gradients leave the
    backward in the params' layout."""
    del constrain_grads
    if mesh is not None and not hasattr(mesh, "group"):
        raise TypeError(f"mesh must be a launch.mesh.Mesh, not "
                        f"{type(mesh).__name__}")
    if accum_steps > 1 and shape.global_batch % accum_steps:
        raise ValueError(f"global batch {shape.global_batch} does not "
                         f"divide into accum_steps={accum_steps} slices")
    return _mesh_program(cfg, run, shape, opt_cfg or opt.OptimizerConfig(),
                         torch.device(device),
                         mesh if mesh is not None else OneDevice(), zcfg,
                         accum_steps, zebra_streams)


# ---------------------------------------------------------------------------
# The mesh program
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardContext:
    """``RunConfig.shard`` of the mesh program: the collectives the model
    code runs. ``tp_group``: the "model" group when attention is tensor
    parallel (None: attention is computed whole on each rank);
    ``batch_group`` / ``n_batch``: the batch shards; ``layer_plans``:
    {stacked leaf path: [(dim of one layer, group)]} of the per-layer
    weight gathers."""

    tp_group: Any = None
    batch_group: Any = None
    n_batch: int = 1
    layer_plans: dict = dataclasses.field(default_factory=dict)

    def attn_reduce(self, t):
        """Sum a tensor-parallel attention output over the heads' ranks."""
        return C.all_reduce(t, self.tp_group)

    def batch_mean(self, t):
        """The mean over the batch shards of a per-shard mean."""
        if self.n_batch == 1:
            return t
        return C.all_reduce(t, self.batch_group) / self.n_batch

    def gather_layer(self, tree, prefix: str):
        """One layer of the stacked tree at ``prefix``, each weight
        all-gathered over the mesh axes its compute does not shard."""
        if not self.layer_plans:
            return tree

        def walk(t, path):
            out = {}
            for k, v in t.items():
                p = f"{path}/{k}"
                if isinstance(v, dict):
                    out[k] = walk(v, p)
                    continue
                for d, g in self.layer_plans.get(p, ()):
                    v = C.all_gather(v, d, g)
                out[k] = v
            return out
        return walk(tree, prefix)


@dataclasses.dataclass
class MeshLayout:
    """Where the mesh program keeps what, for one rank: every leaf's full
    shape and fitted spec (``param_specs``; ``opt_specs`` in the
    optimizer state's tree), the batch axes and this rank's block of
    them."""

    mesh: Any
    cfg: ModelConfig
    shapes: dict
    param_specs: dict
    opt_specs: dict
    batch_axes: tuple
    n_batch: int
    batch_block: int

    def local(self, path: str, full):
        """This rank's block of a full param leaf."""
        return local_slice(self.param_specs[path], self.mesh, self.mesh.rank,
                           full)

    def init_params(self, seed: int, device, param_dtype):
        """The one-device init (same generator, same order), each leaf
        cut to this rank's block as it is drawn."""
        gen = torch.Generator(device=device).manual_seed(seed)

        def walk(specs, prefix):
            out = {}
            for k, v in specs.items():
                path = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    out[k] = walk(v, path)
                    continue
                full = materialize(v, gen, device)
                if param_dtype != torch.float32:
                    full = full.to(param_dtype)
                t = self.local(path, full)
                out[k] = full if t.shape == full.shape else \
                    t.clone(memory_format=torch.contiguous_format)
            return out
        return walk(stack.param_specs(self.cfg), "")

    def init_opt(self, params, master_weights: bool):
        """Zero moments of each leaf's (ZeRO-1) block, the step counter,
        and the f32 master blocks."""
        leaves = flatten(params)
        mesh, mu_specs = self.mesh, self.opt_specs["mu"]
        dev = next(iter(leaves.values())).device
        zeros = {k: torch.zeros(local_shape(mu_specs[k], self.shapes[k], mesh),
                                dtype=torch.float32, device=p.device)
                 for k, p in leaves.items()}
        st = {"mu": zeros,
              "nu": {k: torch.zeros_like(v) for k, v in zeros.items()},
              "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if master_weights:
            st["master"] = {
                k: local_slice(mu_specs[k], mesh, mesh.rank, p.detach()
                               .float()).clone(
                    memory_format=torch.contiguous_format)
                if mu_specs[k] != self.param_specs[k]
                else p.detach().float().clone()
                for k, p in leaves.items()}
        return st

    def rows(self, batch: int, accum_steps: int, microbatches) -> list:
        """This rank's rows of a global batch, in its local order: for
        each accumulation slice i and zebra microbatch k, the batch
        block's share of that global row range (the JAX layout)."""
        Ba = batch // accum_steps
        R = microbatches(Ba)
        n = Ba // R
        if n % self.n_batch:
            raise ValueError(f"{n} rows per microbatch do not split over "
                             f"{self.n_batch} batch shards "
                             f"{self.batch_axes}")
        m = n // self.n_batch
        lo = self.batch_block * m
        return [i * Ba + k * n + lo + j for i in range(accum_steps)
                for k in range(R) for j in range(m)]


def _microbatches(zcfg) -> Callable:
    """The zebra override's microbatch count for a batch of B rows."""
    def fn(B):
        R = zcfg.num_microbatches if (zcfg is not None and zcfg.pipeline) \
            else 1
        while R > 1 and B % R:
            R -= 1
        return R
    return fn


def _gather_plan(stored, use) -> list:
    """(dim, axis) pairs a leaf is all-gathered over at use."""
    out = []
    for d, (e, u) in enumerate(zip(stored, use)):
        if e is not None and u is None:
            if not isinstance(e, str):
                raise NotImplementedError(f"a weight dim over {e}")
            out.append((d, e))
    return out


def _mesh_program(cfg: ModelConfig, run: RunConfig, shape: ShapeConfig,
                  opt_cfg, device, mesh, zcfg, accum_steps: int,
                  zebra_streams: bool) -> TrainProgram:
    """The train program of ``cfg`` on ``mesh`` (the JAX package's
    step.py:88-140 and its jit, rank by rank)."""
    world, rank = mesh.size, mesh.rank
    if cfg.is_moe:
        variant = "hybrid" if (zcfg is not None
                               and zcfg.mode == "replicated") else "ep"
    else:
        variant = "default"
    rules = rules_for(cfg, mesh, variant=variant)
    B = shape.global_batch
    zebra = zcfg is not None and cfg.is_moe
    if zcfg is not None:
        zcfg = fit_zebra(zcfg, cfg, B, mesh=mesh,
                         batch_axes=rules.batch_axes)

    flat = stack.flat_param_specs(cfg)
    shapes = {k: tuple(s.shape) for k, s in flat.items()}
    axes = {k: s.axes for k, s in flat.items()}
    pspecs = fitted_specs(shapes, axes, rules, mesh)
    master = run.policy.param_dtype != torch.float32
    zr = _zero1_rules(rules)
    ospecs = {k: fitted_specs(shapes, v, zr, mesh) if isinstance(v, dict)
              else () for k, v in opt.opt_state_axes(
                  axes, master_weights=master).items()}
    baxes = fit_batch_axes(B, mesh, rules.batch_axes)
    nb = mesh.size_of(baxes)
    bblock = block_index(baxes, mesh, rank)[0]

    M = mesh.shape["model"]
    tp = variant in ("hybrid", "tp") and M > 1
    attn_tp = tp and cfg.n_heads % M == 0 and cfg.n_kv_heads % M == 0
    own_experts = zebra and not (zcfg.mode == "alltoall"
                                 and zcfg.offload_experts)

    def use_spec(path):
        out = []
        for e, lg in zip(pspecs[path], axes[path]):
            keep = e == "model" and (
                (lg == "expert" and own_experts)
                or (lg in ("q_heads", "kv_heads") and attn_tp))
            out.append(e if keep else None)
        return tuple(out)

    plans = {k: _gather_plan(pspecs[k], use_spec(k)) for k in shapes}
    # stacked layers gather one layer at a time inside their block
    stacked = {k for k in plans
               if k.startswith(("blocks/", "encoder/blocks/"))}
    head = "embed/table" if cfg.tie_embeddings else "lm_head"
    vp = tp and pspecs[head] == ("model", None)
    layout = MeshLayout(mesh=mesh, cfg=cfg, shapes=shapes,
                        param_specs=pspecs, opt_specs=ospecs,
                        batch_axes=baxes, n_batch=nb, batch_block=bblock)

    ctx = ShardContext(
        tp_group=mesh.group("model") if attn_tp else None,
        batch_group=mesh.group(baxes), n_batch=nb,
        layer_plans={k: [(d - 1, mesh.group(a)) for d, a in plans[k]]
                     for k in stacked if plans[k]})
    mrun = dataclasses.replace(run, shard=ctx)
    cd = run.policy.compute_dtype
    override = None
    if zebra:
        override = zebra_spmd.make_layer_override(
            cfg, mrun, zcfg, mesh=mesh, streams=zebra_streams)
    microbatches = _microbatches(zcfg if zebra else None)
    world_group = mesh.group(mesh.axis_names)
    vocab = None
    if vp:
        v_loc = shapes[head][0] // M
        vocab = (mesh.coords["model"] * v_loc, mesh.group("model"))

    def gather_params(params):
        def walk(tree, prefix):
            out = {}
            for k, v in tree.items():
                path = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    out[k] = walk(v, path)
                    continue
                if path not in stacked:
                    for d, a in plans[path]:
                        v = C.all_gather(v, d, mesh.group(a))
                out[k] = v
            return out
        return walk(params, "")

    def loss_fn(params, batch):
        full = gather_params(params)
        hidden, _, aux = stack.apply_model(
            full, cfg, mrun, batch["tokens"],
            encoder_embeds=batch.get("encoder_embeds"),
            vision_embeds=batch.get("vision_embeds"), return_hidden=True,
            layer_override=override)
        tree = params if vp else full
        table = tree.get("lm_head", tree["embed"]["table"])
        _, m = chunked_xent_from_hidden(hidden, table.to(cd),
                                        batch["targets"], vocab=vocab)
        nll, zl = ctx.batch_mean(m["nll"]), ctx.batch_mean(m["z_loss"])
        loss = nll + 1e-4 * zl
        loss = loss + aux.get("moe_aux_loss", 0.0) \
            + aux.get("moe_z_loss", 0.0)
        metrics = dict(nll=nll, z_loss=zl, **aux, loss=loss)
        return loss, metrics

    def local_batch(batch):
        B = batch["tokens"].shape[0]
        rows = layout.rows(B, accum_steps, microbatches)
        if len(rows) == B:  # one batch shard: the whole batch
            return {k: v.to(device, non_blocking=True)
                    for k, v in batch.items()}
        idx = torch.tensor(rows, dtype=torch.long)
        return {k: v.index_select(0, idx.to(v.device)).to(
                    device, non_blocking=True) for k, v in batch.items()}

    def one_grad(params, batch):
        leaves = flatten(params)
        for p in leaves.values():
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, batch)
            obj = loss / world if world > 1 else loss
            grads = torch.autograd.grad(obj, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        finally:
            for p in leaves.values():
                p.requires_grad_(False)
        return (dict(zip(leaves, grads)),
                {k: v.detach() for k, v in metrics.items()})

    def grad_fn(params, batch):
        batch = local_batch(batch)
        if accum_steps == 1:
            grads, metrics = one_grad(params, batch)
        else:
            g_sum, ms = None, []
            n = batch["tokens"].shape[0] // accum_steps
            for i in range(accum_steps):
                g, m = one_grad(params, {k: v[i * n:(i + 1) * n]
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
        with torch.no_grad():  # the sum over the ranks holding a copy
            for k, g in grads.items():
                rep = tuple(a for a in mesh.axis_names
                            if a not in spec_axes(pspecs[k]))
                grads[k] = C.all_reduce(g, mesh.group(rep))
        return grads, metrics

    copies = {k: world // mesh.size_of(spec_axes(s))
              for k, s in pspecs.items()}
    norm_weights = {k: 1.0 / n for k, n in copies.items()}
    zero1 = {}  # the leaves whose moments are cut finer than the param
    for k, ms in ospecs["mu"].items():
        if ms == pspecs[k]:
            continue
        plan = _gather_plan(ms, pspecs[k])

        def take(t, ms=ms):
            return local_slice(ms, mesh, rank, t)

        def gather(t, plan=plan):
            for d, a in plan:
                t = C.gather_nograd(t, d, mesh.group(a))
            return t
        zero1[k] = (take, gather)

    def train_step(params, opt_state, batch):
        grads, metrics = grad_fn(params, batch)
        params, opt_state, om = opt.adamw_update(
            opt_cfg, params, grads, opt_state, norm_weights=norm_weights,
            norm_reduce=lambda t: C.all_reduce(t, world_group),
            zero1=zero1)
        metrics.update(om)
        return params, opt_state, metrics

    return TrainProgram(cfg=cfg, run=mrun, opt_cfg=opt_cfg, device=device,
                        train_step=train_step, grad_fn=grad_fn,
                        loss_fn=loss_fn, zcfg=zcfg, layout=layout)
