"""The serving mesh: what a rank of a DATA x MODEL mesh holds, gathers
and computes when it serves (the JAX package's serving programs on a
mesh, ``repro/serve/engine.py:38-86``, ``:263-283``, the "serve" variant
of ``repro/sharding/rules.py`` and the constrainer those programs
install), without jax.

* Weights: each rank stores its block of every param under the fitted
  "serve" rules (2D FSDP; the experts over "model", and under
  expert-parallel decode the placed expert stacks over "model" only, as
  ``ep_param_shardings`` pins them). A stacked layer's weights are
  gathered at the layer's start (``ShardContext.layer_plans``), the
  others once a step (:meth:`ServeLayout.gather_params`): over "data"
  always, over "model" only where the compute does not split them.
* Tensor parallelism over "model" (the JAX constrainer's "serve" rules:
  every activation axis on "model"; :class:`TPPlan`): a rank computes
  its block of ceil(H / M) q heads (and the kv heads they read), of
  ceil(F / M) "mlp" columns of each dense FFN, of the RG-LRU channels and
  SSD heads its recurrent state blocks hold, and of ceil(V / M) rows of
  the vocabulary; a dim of fewer entries than ranks stays whole, as the
  constrainer leaves it. A weight whose split dim is stored cut over
  "model" keeps its block, regrouped by one all-to-all
  (``collectives.fetch``) where the stored blocks are not the compute's
  (24 heads over 16 ranks); one stored whole is cut at use. Partial
  results are summed over "model"; a prefill of at least M positions
  keeps its residual stream between blocks as the rank's seq block
  (``ShardContext.seq_for``), the block's last sum a reduce-scatter.
* Decode state (:func:`decode_state_specs`, :func:`paged_state_specs`,
  leaf by leaf the JAX package's specs): dense KV caches split their
  sequence dim over "model" and their slots over "data"; paged pools
  split their page dim over "model" and are replicated over "data". A
  rank allocates only its blocks, which hold every kv head: the new
  tokens' k and v are gathered over the heads' ranks before the write,
  the queries over them before the attention over the rank's own lines
  or pages, and the partial results of each rank's heads come back to
  it by one all-to-all and are merged by log-sum-exp
  (``models.modules.merge_partials``).
* Recurrent states (RG-LRU ``conv`` / ``lru``, SSD ``conv`` / ``ssm``):
  each rank stores the block its spec gives it (channels over "model").
  Where a layer's blocks are the rank's channels or heads over "model"
  the mixer runs on them (:class:`RecurrentBlocks` hands it the plan
  under ``tp``); otherwise a layer reads its blocks gathered over the
  dims they are cut on and cut to the step's rows, runs its mixer whole
  and keeps its block of the new state; an SSD ``ssm`` state cut over
  heads otherwise stays a block, its decode runs on those heads and
  all-gathers its output ``y``. The insert of a prefilled state into a
  slot follows each leaf's own spec (:meth:`ServeLayout.insert`).
* Slots: each data rank decodes the slots that ``slot_vector_spec`` gives
  its block (all of them where the slot count does not divide); the
  sampled logits are all-gathered over "data" before sampling, so every
  rank samples every slot alike and the host-side scheduler, allocator
  and prefix index, replicated, take the same decisions. Prefill runs at
  batch 1 on every rank (the JAX package's ``batch_axes=()``); the
  lockstep server's whole-batch steps split their rows over "data" as
  the decode does.

A one-device program is the 1x1 mesh (``train.step.OneDevice``): no
block is cut, no group exists, nothing is gathered, every plan is None.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import stack
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (ShardingRules, block_index,
                                        entry_axes, fit_spec,
                                        fitted_specs, local_shape,
                                        local_slice, paged_pool_spec,
                                        rules_for, slot_vector_spec)
from repro_torch.train.step import (BlockPlan, HeadPlan, OneDevice,
                                    ShardContext, _blocks_of, _gather_plan,
                                    fit_batch_axes)

EXPERT_KEYS = ("wi_gate", "wi_up", "wo")
RECURRENT_LEAVES = ("conv", "lru", "ssm")
# the logical axes the "serve" rules put on "model" for activations and
# weights alike: a weight's first such dim is the one its compute splits
TP_AXES = ("q_heads", "kv_heads", "mlp", "vocab")


# ---------------------------------------------------------------------------
# Decode-state specs (repro/serve/engine.py:38-86, :263-283)
# ---------------------------------------------------------------------------

def _state_spec_for(cfg: ModelConfig, mesh, b, kv_bodies):
    """The JAX package's shared decode-state leaf-spec mapper: recurrent
    leaves split their batch over "data" and channels over "model", the
    attention-cache leaves take ``kv_bodies(tail, ndim)``. A leaf counts as
    stacked when its first dim equals ``n_pattern_repeats`` (> 1), as
    there. Returns ``spec_for(name, shape)``."""
    mdl = "model"

    def spec_for(name: str, shape) -> tuple:
        n = cfg.n_pattern_repeats
        stacked = len(shape) and shape[0] == n and n > 1
        lead = (None,) if stacked else ()
        tail = name.rsplit("/", 1)[-1]
        if tail in ("k", "v", "pos"):
            body = (*lead, *kv_bodies(tail, len(shape) - len(lead)))
        else:
            body = {
                "conv": (*lead, b, None, mdl),
                "lru": (*lead, b, mdl),
                "ssm": (*lead, b, mdl, None, None),
            }.get(tail, (*lead, *([None] * (len(shape) - len(lead)))))
        return fit_spec(shape, mesh, body)

    return spec_for


def _shapes(state) -> dict:
    return {k: tuple(v.shape) for k, v in stack.state_leaves(state).items()}


def decode_state_specs(cfg: ModelConfig, mesh, rules: ShardingRules,
                       batch: int, max_len: int,
                       dtype=torch.bfloat16) -> dict:
    """{leaf name: spec} of the dense decode state: KV caches split their
    sequence dim over "model" (flash-decoding style) and their batch over
    the fitted batch axes; recurrent states their channels over "model"."""
    baxes = fit_batch_axes(batch, mesh, rules.batch_axes)
    b = baxes if baxes else None
    kv = {"k": (b, "model", None, None), "v": (b, "model", None, None),
          "pos": (b, "model")}
    spec_for = _state_spec_for(cfg, mesh, b, lambda tail, nd: kv[tail])
    shapes = _shapes(stack.init_decode_state(cfg, batch, max_len, dtype,
                                             "meta"))
    return {k: spec_for(k, s) for k, s in shapes.items()}


def paged_state_specs(cfg: ModelConfig, mesh, rules: ShardingRules,
                      batch: int, n_pages: int, page_size: int,
                      dtype=torch.bfloat16) -> dict:
    """{leaf name: spec} of the paged decode state: the KV pools split
    their page dim over "model" (``paged_pool_spec``); per-slot recurrent
    states as in :func:`decode_state_specs`."""
    baxes = fit_batch_axes(batch, mesh, rules.batch_axes)
    b = baxes if baxes else None
    spec_for = _state_spec_for(
        cfg, mesh, b,
        lambda tail, nd: paged_pool_spec(n_pages, mesh, rules, ndim=nd))
    shapes = _shapes(stack.init_paged_decode_state(cfg, batch, n_pages,
                                                   page_size, dtype, "meta"))
    return {k: spec_for(k, s) for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# A rank's layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PoolShard:
    """This rank's block of a paged pool split by page over ``group``:
    pages [rank * pages / size, (rank + 1) * pages / size)."""

    rank: int
    size: int
    pages: int
    group: Any


def _take(mesh, t, dim: int, entry):
    """This rank's block of ``t`` along ``dim`` under spec entry
    ``entry`` (``t`` itself where the entry cuts nothing)."""
    i, n = block_index(entry, mesh, mesh.rank)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def _cut_axes(mesh, entry) -> tuple:
    """The axes of size > 1 a spec entry cuts over: the same on every rank
    (where a block's index is not), so the ranks of a group take the same
    branch before a collective."""
    return tuple(a for a in entry_axes(entry) if mesh.shape[a] > 1)


def _gather(mesh, t, dim: int, entry):
    """The whole of ``t`` along ``dim`` from the blocks ``entry`` cuts."""
    return C.gather_nograd(t, dim, mesh.group(entry))


class RecurrentBlocks:
    """How a layer reads and writes this rank's blocks of the per-slot
    recurrent states (``ShardContext.rec``) in a step whose batch is the
    slot rows ``rows``: the decode's rows of ``n_slots`` slots cut by
    ``row_entry`` over ``row_group``, or the batch-1 prefill's one row.

    ``specs``: {leaf name: spec} of the step's state (the JAX package's,
    :func:`decode_state_specs`), followed whatever they are: a leaf of a
    tail whose slot count equals the pattern's repeats is read there as
    stacked, so its cuts fall on other dims than the intent's, and its
    rows need not be cut as the step's. Read (:meth:`read`): each leaf
    all-gathered over every non-row dim its spec cuts (the heads of
    ``ssm`` excepted), then cut to the step's rows (gathered over its own
    row cut first where that differs). Write (:meth:`write`): the mixer's
    new state for the step's rows, all-gathered over ``row_group`` where
    the leaf's rows differ, then this rank's block of every cut dim. An
    ``ssm`` leaf whose heads are cut stays a block: the layer's state
    carries ``heads`` = (first, last, group) and the SSD decode runs on
    those heads (``modules.apply_ssd``). On one rank every gather is the
    identity and every block the whole leaf.

    ``split``: {layer: (first, last, group)} of the layers whose mixer
    runs on this rank's channels (RG-LRU) or heads (SSD) over "model"
    (:meth:`ServeLayout.rec_split`): the layer's state carries them as
    ``tp``, and an RG-LRU layer's ``conv`` and ``lru`` blocks are read
    and written as they are along their channels."""

    def __init__(self, mesh, specs: dict, rows: slice, row_entry,
                 row_group, split: Optional[dict] = None):
        self.mesh, self.rows, self.row_group = mesh, rows, row_group
        self.split = split or {}
        row_axes = _cut_axes(mesh, row_entry)
        # name -> (aligned with the step's rows, row entry, cuts, heads)
        self.leaves = {}
        for name, spec in specs.items():
            leaf = name.rsplit("/", 1)[-1]
            if leaf not in RECURRENT_LEAVES:
                continue
            if name.startswith("blocks/"):  # the per-layer view
                if spec[0] is not None:
                    raise ValueError(f"{name}: spec {spec} cuts the "
                                     f"stacked layer dim")
                spec = spec[1:]
            heads = None
            if leaf == "ssm" and len(spec) > 1 and _cut_axes(mesh, spec[1]):
                heads = (block_index(spec[1], mesh, mesh.rank)[0],
                         mesh.group(spec[1]))
            own = name.rsplit("/", 2)[0] in self.split and \
                name.split("/")[-2] == "rglru"
            cuts = tuple((d, e) for d, e in enumerate(spec)
                         if d > 0 and _cut_axes(mesh, e)
                         and not (heads is not None and d == 1)
                         and not (own and d == len(spec) - 1))
            self.leaves[name] = (_cut_axes(mesh, spec[0]) == row_axes,
                                 spec[0], cuts, heads)

    def read(self, layer: str, state: dict) -> dict:
        """The layer state a mixer runs on: every recurrent leaf of layer
        ``layer`` ("blocks/pos0", "tails/1") whole along its channels and
        cut to the step's rows; the attention cache as it is."""
        out = {}
        for kind, leaves in state.items():
            if kind == "kv":
                out[kind] = leaves
                continue
            sub = {}
            for k, t in leaves.items():
                aligned, rows, cuts, heads = self.leaves[
                    f"{layer}/{kind}/{k}"]
                for d, e in cuts:
                    t = _gather(self.mesh, t, d, e)
                if not aligned:
                    t = _gather(self.mesh, t, 0, rows)[self.rows]
                sub[k] = t
                if heads is not None:
                    i, group = heads
                    sub["heads"] = (i * t.shape[1], (i + 1) * t.shape[1],
                                    group)
            if layer in self.split:
                sub["tp"] = self.split[layer]
            out[kind] = sub
        return out

    def write(self, layer: str, state: dict, new: dict) -> None:
        """Copy this rank's blocks of a layer's new recurrent state (the
        step's rows, as :meth:`read` gave them) into ``state``'s leaves,
        in place."""
        for kind, leaves in state.items():
            if kind == "kv":
                continue
            for k, dst in leaves.items():
                aligned, rows, cuts, _ = self.leaves[f"{layer}/{kind}/{k}"]
                t = new[kind][k]
                if not aligned:
                    t = _take(self.mesh, C.gather_nograd(
                        t, 0, self.row_group), 0, rows)
                for d, e in cuts:
                    t = _take(self.mesh, t, d, e)
                dst.copy_(t)


class TPPlan:
    """This rank's tensor-parallel blocks over "model" on the serving mesh
    of ``cfg`` (all None / empty on a model axis of one rank), and the
    entries of every split weight each model rank computes with
    (:meth:`needs`).

    ``head_plans``: every model rank's ``train.step.HeadPlan`` (q heads in
    blocks of ceil(H / M), the kv heads they read; its weights are given
    cut already) where H >= M; ``ffn`` / ``vocab``: this rank's
    ``train.step.BlockPlan`` of the dense FFN's d_ff and of the
    vocabulary where they are >= M; ``rec``: {param layer prefix
    ("blocks/pos0", "tail1"): (mixer, first, last, n)} of the recurrent
    layers whose states this rank holds as its block [first, last) of
    the n channels (RG-LRU) or heads (SSD) over "model"
    (:meth:`ServeLayout.rec_split`)."""

    def __init__(self, cfg: ModelConfig, mesh, group, rec: dict):
        M, r = mesh.shape["model"], mesh.coords["model"]
        self.cfg, self.M, self.rank, self.rec = cfg, M, r, rec
        self.group = group
        H, KH = cfg.n_heads, cfg.n_kv_heads
        self.head_plans = tuple(
            dataclasses.replace(HeadPlan.of(H, KH, M, s), q_local=True,
                                kv_local=True)
            for s in range(M)) if M > 1 and H >= M else ()
        self.ffn = BlockPlan.of(cfg.d_ff, M, r, group) \
            if M > 1 and cfg.d_ff >= M else None
        self.vocab = BlockPlan.of(cfg.vocab_size, M, r, group) \
            if M > 1 and cfg.vocab_size >= M else None
        self.specs = {f"blocks/pos{p}": s for p, s in enumerate(cfg.pattern)}
        self.specs.update({f"tail{i}": s
                           for i, s in enumerate(cfg.tail_specs)})
        if cfg.is_encdec:
            self.specs["encoder/blocks/pos0"] = stack.ENCODER_SPEC

    @property
    def heads(self):
        return self.head_plans[self.rank] if self.head_plans else None

    def fields(self) -> dict:
        """The ``ShardContext`` fields of these plans: the attention's
        partial sums over ``tp_group`` only where its heads are split."""
        return dict(tp_group=self.group if self.heads is not None else None,
                    heads=self.heads, head_plans=self.head_plans,
                    ffn=self.ffn, vocab=self.vocab)

    def _ranges(self, per_rank) -> tuple:
        """((lo, hi), ...) of each rank, the empty ones dropped."""
        return tuple(tuple((a, b) for a, b in rs if a < b)
                     for rs in per_rank)

    def needs(self, path: str, axes: tuple):
        """(dim, needs) of leaf ``path`` (its logical ``axes``): the dim
        its compute splits over "model" and, for each model rank, the
        [lo, hi) ranges of that dim it computes with; None for a leaf
        every rank uses whole."""
        dims = [i for i, a in enumerate(axes) if a in TP_AXES]
        if not dims or self.M == 1:
            return None
        dim, M, cfg = dims[0], self.M, self.cfg
        if path in ("embed/table", "lm_head"):
            if self.vocab is None:
                return None
            return dim, self._ranges(
                [(_blocks_of(cfg.vocab_size, M, s),) for s in range(M)])
        parts = path.split("/")
        leaf, sub, layer = parts[-1], parts[-2], "/".join(parts[:-2])
        spec = self.specs.get(layer)
        if spec is None:
            return None
        hd = cfg.head_dim
        if sub in ("mixer", "xattn") and leaf in ("wq", "wk", "wv", "wo") \
                and self.head_plans:
            key = "kv" if leaf in ("wk", "wv") else "q"
            return dim, self._ranges(
                [((getattr(p, key)[0] * hd, getattr(p, key)[1] * hd),)
                 for p in self.head_plans])
        if sub == "ffn" and spec.ffn == "dense" and self.ffn is not None:
            return dim, self._ranges(
                [(_blocks_of(cfg.d_ff, M, s),) for s in range(M)])
        if sub != "mixer" or layer not in self.rec:
            return None
        kind, n = self.rec[layer][0], self.rec[layer][3]
        if kind == "rglru":
            w = cfg.lru_width
            return dim, self._ranges([((s * w // M, (s + 1) * w // M),)
                                      for s in range(M)])
        din = cfg.ssm_expand * cfg.d_model
        ns, hs = cfg.ssm_state, din // cfg.ssm_heads
        out = []
        for s in range(M):
            lo, hi = s * n // M, (s + 1) * n // M
            x = (lo * hs, hi * hs)
            out.append({
                "in_proj": (x, (din + x[0], din + x[1]),
                            (2 * din, 2 * din + 2 * ns),
                            (2 * din + 2 * ns + lo, 2 * din + 2 * ns + hi)),
                "conv_w": (x, (din, din + 2 * ns)),
                "conv_b": (x, (din, din + 2 * ns)),
            }.get(leaf, (x,)))
        return dim, self._ranges(out)


def is_expert_path(path: str) -> bool:
    parts = path.split("/")
    return len(parts) >= 2 and parts[-2] == "ffn" and parts[-1] in EXPERT_KEYS


class ServeLayout:
    """What one rank of ``mesh`` holds and gathers for a serving program
    of ``n_slots`` slots and ``max_len`` lines (see the module docstring).
    ``ep``: expert-parallel decode, whose placed expert stacks stay split
    over "model" (each EP rank computes with its own). ``ep_moe``: the
    lockstep server's MoE (``zebra_spmd.make_ep_moe`` over the mesh),
    whose expert stacks, stored under the "serve" rules, are gathered but
    for their expert dim, which stays cut over "model"."""

    def __init__(self, cfg: ModelConfig, mesh, *, n_slots: int,
                 max_len: int, dtype, device, ep: bool = False,
                 ep_moe: bool = False):
        self.cfg, self.mesh = cfg, mesh if mesh is not None else OneDevice()
        mesh = self.mesh
        self.n_slots, self.max_len = n_slots, max_len
        self.dtype, self.device, self.ep = dtype, torch.device(device), ep
        self.rules = rules_for(cfg, mesh, variant="serve")
        flat = stack.flat_param_specs(cfg)
        self.shapes = {k: tuple(s.shape) for k, s in flat.items()}
        axes = {k: s.axes for k, s in flat.items()}
        self.param_specs = fitted_specs(self.shapes, axes, self.rules, mesh)
        self.model_group = mesh.group("model")
        self._specs = {}
        self.tp = TPPlan(cfg, mesh, self.model_group, self.rec_split())
        use = {k: (None,) * len(s) for k, s in self.param_specs.items()}
        # {leaf: (dim, needs, stored cut)} of the weights split over
        # "model" at use: a block stored over "model" stays cut there
        self.takes = {}
        for k, s in self.param_specs.items():
            nd = self.tp.needs(k, axes[k])
            if nd is None:
                continue
            d, needs = nd
            if s[d] not in (None, "model"):
                raise ValueError(f"{k}: dim {d} stored over {s[d]}")
            self.takes[k] = (d, needs, s[d] == "model")
            if s[d] == "model":
                use[k] = use[k][:d] + ("model",) + use[k][d + 1:]
        if ep:
            for k, shp in self.shapes.items():
                if is_expert_path(k):
                    spec = (None,) * (len(shp) - 3) + ("model", None, None)
                    self.param_specs[k] = use[k] = spec
        if ep_moe:
            for k in self.shapes:
                if is_expert_path(k) and self.param_specs[k][-3] == "model":
                    use[k] = use[k][:-3] + ("model", None, None)
        self.plans = {k: _gather_plan(self.param_specs[k], use[k])
                      for k in self.shapes}
        self.stacked = {k for k in self.plans
                        if k.startswith(("blocks/", "encoder/blocks/"))}
        baxes = fit_batch_axes(n_slots, mesh, self.rules.batch_axes)
        self.batch_axes = baxes
        self.slot_spec = slot_vector_spec(n_slots, mesh, self.rules)
        idx, n = block_index(self.slot_spec[0], mesh, mesh.rank)
        per = n_slots // n
        self.rows = slice(idx * per, (idx + 1) * per)
        self.slot_group = mesh.group(baxes) if n > 1 else None
        self.split = mesh.size > 1

    # -- params --------------------------------------------------------

    def local_params(self, params):
        """This rank's blocks of a param tree, whole or cut already (an EP
        placement's expert stacks are the rank's own; the ``eslot`` maps
        are replicated)."""
        if not self.split:
            return params

        def walk(tree, prefix):
            out = {}
            for k, v in tree.items():
                path = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    out[k] = walk(v, path)
                elif path not in self.param_specs:
                    out[k] = v
                else:
                    out[k] = self._cut(path, v)
            return out
        return walk(params, "")

    def init_params(self, seed: int = 0):
        """The one-device seed-``seed`` init (same generator, same order),
        each leaf cut to this rank's block as it is drawn."""
        from repro_torch.pytree import materialize
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def walk(specs, prefix):
            out = {}
            for k, v in specs.items():
                path = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    out[k] = walk(v, path)
                    continue
                full = materialize(v, gen, self.device)
                out[k] = self._cut(path, full) if self.split else full
            return out
        return walk(stack.param_specs(self.cfg), "")

    def _cut(self, path, v):
        """This rank's block of leaf ``path``: ``v`` as it is when it is
        the block already (a placed expert stack, a tree cut before)."""
        spec, full = self.param_specs[path], self.shapes[path]
        if tuple(v.shape) != full:
            if tuple(v.shape) != local_shape(spec, full, self.mesh):
                raise ValueError(f"{path}: {tuple(v.shape)} is neither the "
                                 f"leaf {full} nor this rank's block")
            return v
        t = local_slice(spec, self.mesh, self.mesh.rank, v)
        return v if t.shape == v.shape else \
            t.clone(memory_format=torch.contiguous_format)

    def _take(self, path: str, layer: bool):
        """The cut of leaf ``path`` (one layer of it with ``layer``) to
        the entries this rank computes with: an all-to-all of the stored
        blocks over "model" (``collectives.fetch``; none where they are
        the compute's blocks), or a slice of a leaf stored whole."""
        d, needs, stored_cut = self.takes[path]
        d -= int(layer)
        if stored_cut:
            group = self.model_group
            return lambda v: C.fetch(v, d, group, needs)
        rs = needs[self.mesh.coords["model"]] or ((0, 0),)
        if len(rs) == 1:
            return lambda v: v.narrow(d, rs[0][0], rs[0][1] - rs[0][0])
        return lambda v: torch.cat([v.narrow(d, a, b - a) for a, b in rs],
                                   d)

    def gather_params(self, params):
        """The tree a step runs on: every non-stacked leaf cut to this
        rank's entries where its compute splits over "model", then
        all-gathered over the axes its block is cut on but for those (the
        stacked layers per layer, ``ShardContext.gather_layer``)."""
        if not self.split:
            return params

        def walk(tree, prefix):
            out = {}
            for k, v in tree.items():
                path = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    out[k] = walk(v, path)
                    continue
                if path not in self.stacked:
                    if path in self.takes:
                        v = self._take(path, False)(v)
                    for d, a in self.plans.get(path, ()):
                        v = C.gather_nograd(v, d, self.mesh.group(a))
                out[k] = v
            return out
        return walk(params, "")

    def rec_split(self) -> dict:
        """{param layer prefix: (mixer, first, last, n)} of the recurrent
        layers whose mixer runs on this rank's block over "model": an
        RG-LRU layer whose ``conv`` and ``lru`` states are cut along
        their channels over "model" alone, an SSD layer whose ``ssm``
        state is cut along its heads so, in the decode state and in the
        prefill's alike ([first, last) of n channels or heads)."""
        mesh, M = self.mesh, self.mesh.shape["model"]
        out = {}
        if M == 1:
            return out
        dec, pre = self.state_specs(self.n_slots), self.state_specs(1)
        cfg = self.cfg

        def body(specs, name):
            spec = specs[name]
            return spec[1:] if name.startswith("blocks/") else spec
        r = mesh.coords["model"]
        for name in dec:
            layer, kind, leaf = name.rsplit("/", 2)
            if (kind, leaf) not in (("rglru", "lru"), ("ssd", "ssm")):
                continue
            if kind == "rglru":
                ok = all(body(sp, f"{layer}/rglru/{lf}")[-1] == "model"
                         for sp in (dec, pre) for lf in ("conv", "lru"))
                n = cfg.lru_width
            else:
                ok = all(body(sp, name)[1] == "model" for sp in (dec, pre))
                n = cfg.ssm_heads
            if ok:
                prefix = layer if layer.startswith("blocks/") else \
                    "tail" + layer.split("/")[1]
                out[prefix] = (kind, r * n // M, (r + 1) * n // M, n)
        return out

    def context(self, *, decode: bool, n_pages: int = 0) -> ShardContext:
        """``RunConfig.shard`` of the decode step (``decode``: its slots
        split over "data") or of the batch-1 prefill."""
        mesh, tp, group = self.mesh, self.tp, self.model_group
        plans = {k: [(d - 1, mesh.group(a)) for d, a in self.plans[k]]
                 for k in self.stacked if self.plans[k]}
        takes = {k: self._take(k, True) for k in self.takes
                 if k in self.stacked}
        split = {(k if k.startswith("blocks/") else "tails/" + k[4:]):
                 (lo, hi, group) for k, (_, lo, hi, _) in tp.rec.items()}
        rec = RecurrentBlocks(mesh, self.state_specs(self.n_slots),
                              self.rows, self.slot_spec[0],
                              self.slot_group, split) if decode else \
            RecurrentBlocks(mesh, self.state_specs(1), slice(0, 1), None,
                            None, split)
        return ShardContext(
            **tp.fields(), layer_plans=plans, layer_takes=takes,
            kv_group=group, kv_rank=mesh.coords["model"],
            kv_size=mesh.shape["model"],
            kv_lines=self.max_len, kv_pages=n_pages,
            slot_group=self.slot_group if decode else None, rec=rec)

    # -- state ---------------------------------------------------------

    def state_specs(self, batch: int) -> dict:
        """{leaf name: spec} of the dense decode state of ``batch`` rows
        (the recurrent leaves' specs are the paged state's too)."""
        if batch not in self._specs:
            self._specs[batch] = decode_state_specs(
                self.cfg, self.mesh, self.rules, batch, self.max_len,
                self.dtype)
        return self._specs[batch]

    def insert(self, dst, src, slot: int) -> None:
        """Write the batch-1 state ``src`` (a prefill's blocks) into row
        ``slot`` of each leaf of ``dst`` (this rank's blocks of the
        decode state, or of its recurrent part) that ``src`` names, in
        place. Each leaf follows its own spec: the rank writes the row
        where its block holds that slot, and a leaf whose non-row dims are
        cut otherwise than the prefill's is re-blocked from the whole of
        it (gathered on every rank, as every rank inserts)."""
        slot = int(slot)
        dsp, ssp = self.state_specs(self.n_slots), self.state_specs(1)
        srcs = stack.state_leaves(src)
        mesh = self.mesh
        for name, d in stack.state_leaves(dst).items():
            s = srcs[name]
            axis = 1 if name.startswith("blocks/") else 0
            ds, ss = dsp[name], ssp[name]

            def cuts(spec):
                return [_cut_axes(mesh, e) if i != axis else ()
                        for i, e in enumerate(spec)]
            if cuts(ss) != cuts(ds):
                for i, e in enumerate(ss):
                    if i != axis:
                        s = _gather(mesh, s, i, e)
                for i, e in enumerate(ds):
                    if i != axis:
                        s = _take(mesh, s, i, e)
            i, _ = block_index(ds[axis], mesh, mesh.rank)
            per = d.shape[axis]
            if i * per <= slot < (i + 1) * per:
                d.narrow(axis, slot - i * per, 1).copy_(s)

    def _block(self, specs):
        return lambda name, shape: local_shape(specs[name], shape, self.mesh)

    def dense_state(self, batch: int):
        """This rank's blocks of the dense decode state of ``batch`` slots
        (the program's slots, or 1 for the prefill state)."""
        block = None if not self.split else self._block(decode_state_specs(
            self.cfg, self.mesh, self.rules, batch, self.max_len,
            self.dtype))
        return stack.init_decode_state(self.cfg, batch, self.max_len,
                                       self.dtype, self.device, block=block)

    def paged_state(self, batch: int, n_pages: int, page_size: int):
        block = None if not self.split else self._block(paged_state_specs(
            self.cfg, self.mesh, self.rules, batch, n_pages, page_size,
            self.dtype))
        return stack.init_paged_decode_state(self.cfg, batch, n_pages,
                                             page_size, self.dtype,
                                             self.device, block=block)

    def prefill_carry(self):
        """The batch-1 recurrent carry of the paged prefill."""
        block = None if not self.split else self._block(decode_state_specs(
            self.cfg, self.mesh, self.rules, 1, 1, self.dtype))
        return stack.split_kv_state(stack.init_decode_state(
            self.cfg, 1, 1, self.dtype, self.device, block=block))[1]

    def pool(self, n_pages: int) -> Optional[PoolShard]:
        """This rank's block of a pool of ``n_pages`` pages, None when the
        pool is not split."""
        M = self.mesh.shape["model"]
        if M == 1 or paged_pool_spec(n_pages, self.mesh,
                                     self.rules)[0] is None:
            return None
        return PoolShard(self.mesh.coords["model"], M, n_pages,
                         self.model_group)

    # -- slots ---------------------------------------------------------

    def gather_slots(self, t):
        """A per-slot tensor of this rank's slots -> every slot's."""
        return C.gather_nograd(t, 0, self.slot_group)

    def sum_slots(self, t):
        """A sum over this rank's slots -> the sum over every slot."""
        return C.all_reduce(t, self.slot_group)

    def local_rows(self, x):
        """This rank's rows of a host per-slot array."""
        return np.asarray(x)[self.rows]


def unported_on_mesh(cfg: ModelConfig) -> Optional[str]:
    """What a mesh larger than 1x1 cannot serve of ``cfg`` yet, by name;
    None when it serves it."""
    if cfg.n_pattern_repeats == 1:
        return (f"{cfg.name} repeats its layer pattern once (its cache "
                f"leaves are not stacked, so the JAX specs split their "
                f"slots over 'model', not their lines)")
    return None
