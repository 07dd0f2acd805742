"""Expert-parallel decode with heterogeneity-aware placement (mirror of
``repro/serve/ep_decode.py``, DESIGN.md §11).

The replicated serving engines keep every expert's weights on every decode
device. This module shards the expert stacks over the EP ranks and routes
the decode tokens through the chunked all-to-all of the zebra engines
(§8), so a rank holds E / ep_size experts while the decode step stays
greedy token-exact against the replicated engine.

Placement is data, not layout: experts are stored in PACKED order (rank
j's experts occupy slots ``[j E_loc, (j+1) E_loc)`` of the expert axis)
and an ``eslot`` int32 map, injected beside each MoE FFN's weights, maps
expert id -> slot. Re-placing experts (hot ones on the strong device
class, cold ones on the weak, from the observed routing histogram) is then
a host-side permutation of the weight stacks and a new ``eslot``: KV
pools, page tables and slot state never move, which makes the online
re-balance token-exact mid-trace.

The routing histograms come back from the decode step itself: the EP MoE
hop counts routed copies per GLOBAL expert id (dead slots masked out) and
the stack returns them per layer through ``aux_extras`` / ``layer_aux``;
the engine feeds them to :class:`~repro_torch.serve.metrics.RoutingEMA`
and re-balances when the distribution drifts.

The EP ranks are a ``core.zebra_spmd.EPGroup`` (no process group: one
rank, every collective the identity and no ``torch.distributed`` call; a
gloo or NCCL group: ``torch.distributed`` collectives): on the serving
mesh (``serve.mesh``) the group of its "model" axis. Where the JAX package
pins the expert stacks to the mesh's EP axis (``ep_param_shardings``),
:func:`place_params` given the group keeps only the rank's own slots, so
the residency drop is real per rank; the program's layout cuts the other
leaves to the rank's blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.asym_ea import asym_ea_place, round_robin_placement
from repro_torch.core.zebra_spmd import EPGroup, _pack, _round_up, _unpack
from repro_torch.models import modules, stack
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import RunConfig
from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousProgram
from repro_torch.serve.metrics import RoutingEMA
from repro_torch.serve.scheduler import Scheduler

EXPERT_KEYS = ("wi_gate", "wi_up", "wo")


@dataclasses.dataclass(frozen=True)
class EPDecodeConfig:
    """Expert-parallel decode configuration, field for field the JAX
    package's (DESIGN.md §11).

    ep_size must equal the EP group's size and divide the expert count;
    validation REJECTS a non-dividing ep_size (no silent truncation; the
    launch driver surfaces the ValueError as a non-zero exit).
    ``placement`` is the initial expert -> rank assignment (default
    round-robin); ``rebalance_every`` > 0 checks the routing EMA's drift
    every that many decode steps and re-places experts when the total
    variation exceeds ``drift_threshold``. ``ep_axis`` names the JAX
    mesh's axis; the port has no mesh, so nothing reads it."""

    ep_size: int
    ep_axis: str = "model"
    n_chunks: int = 1           # chunked a2a dispatch (zebra §8 semantics)
    placement: Optional[tuple] = None
    rebalance_every: int = 0    # decode steps between drift checks; 0 = off
    drift_threshold: float = 0.1
    ema_decay: float = 0.9


def validate_ep_config(cfg: ModelConfig, mesh, ep: EPDecodeConfig) -> None:
    """Reject-don't-truncate validation, with the JAX package's messages.
    ``mesh`` (a ``launch.mesh.Mesh`` or any ``sharding.rules.MeshShape``;
    None: one rank): its ``ep.ep_axis`` is the EP axis, as in the JAX
    package."""
    if not cfg.is_moe:
        raise ValueError("EP decode needs a MoE model (n_experts == 0)")
    if ep.ep_size < 1:
        raise ValueError(f"ep_size must be >= 1, got {ep.ep_size}")
    if cfg.n_experts % ep.ep_size:
        raise ValueError(
            f"ep_size {ep.ep_size} does not divide n_experts "
            f"{cfg.n_experts}; refusing to truncate the expert shard")
    if mesh is not None and ep.ep_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {ep.ep_axis!r}")
    size = 1 if mesh is None else mesh.shape[ep.ep_axis]
    if size != ep.ep_size:
        raise ValueError(
            f"ep_size {ep.ep_size} != mesh axis {ep.ep_axis!r} size "
            f"{size}")
    if ep.n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {ep.n_chunks}")
    if ep.placement is not None:
        placement_to_perm(ep.placement, cfg.n_experts, ep.ep_size)


# ---------------------------------------------------------------------------
# Placement as data: packed permutation + expert -> slot map
# ---------------------------------------------------------------------------

def placement_to_perm(placement, n_experts: int, ep_size: int) -> tuple:
    """Validate a placement (tuple of per-rank expert-id tuples) and
    return the packed slot -> expert permutation."""
    if len(placement) != ep_size:
        raise ValueError(f"placement has {len(placement)} shards, "
                         f"expected {ep_size}")
    cap = n_experts // ep_size
    perm = []
    for j, shard in enumerate(placement):
        if len(shard) != cap:
            raise ValueError(f"shard {j} holds {len(shard)} experts, "
                             f"expected {cap} (equal cardinality)")
        perm.extend(int(e) for e in shard)
    if sorted(perm) != list(range(n_experts)):
        raise ValueError("placement is not a permutation of expert ids")
    return tuple(perm)


def eslot_of(placement, n_experts: int) -> np.ndarray:
    """Inverse permutation: expert id -> packed slot index [E] int32."""
    perm = [int(e) for shard in placement for e in shard]
    eslot = np.zeros((n_experts,), np.int32)
    eslot[np.asarray(perm)] = np.arange(n_experts, dtype=np.int32)
    return eslot


def place_params(params, cfg: ModelConfig, placement,
                 group: Optional[EPGroup] = None):
    """Permute every MoE FFN's expert stacks into packed placement order
    and inject the ``eslot`` map. Routers are NOT permuted: routing stays
    in global expert ids; only the storage order changes. Stacked block
    leaves ([L, E, ...]) permute axis 1 and get an [L, E] eslot (one row a
    layer); tail leaves permute axis 0 and get an [E] one.

    With a ``group`` of n ranks each rank keeps only its own slots
    ``[r E_loc, (r+1) E_loc)`` (the JAX package's ``ep_param_shardings``):
    it gathers just those experts, so the full permuted stack never
    exists on it. The other leaves are the caller's tensors."""
    n = len(placement)
    perm = placement_to_perm(placement, cfg.n_experts, n)
    eslot = eslot_of(placement, cfg.n_experts)
    if group is not None and group.size > 1:
        E_loc = cfg.n_experts // n
        perm = perm[group.rank * E_loc:(group.rank + 1) * E_loc]

    def walk(node):
        if isinstance(node, dict):
            if "router" in node and "wi_gate" in node:
                out = dict(node)
                stacked = node["wi_gate"].dim() == 4
                ax = 1 if stacked else 0
                dev = node["wi_gate"].device
                idx = torch.as_tensor(perm, dtype=torch.int64, device=dev)
                for k in EXPERT_KEYS:
                    out[k] = node[k].index_select(ax, idx)
                es = torch.as_tensor(eslot, device=dev)
                if stacked:
                    es = es[None].expand(node["wi_gate"].shape[0],
                                         cfg.n_experts).contiguous()
                out["eslot"] = es
                return out
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


# ---------------------------------------------------------------------------
# The EP decode expert hop
# ---------------------------------------------------------------------------

def make_ep_moe_decode(cfg: ModelConfig, run: RunConfig, ep: EPDecodeConfig,
                       group: Optional[EPGroup] = None) -> Callable:
    """Returns ``moe_fn(ffn_params, x2d [T, d], mask [T]) -> (y2d, aux)``
    on this rank (``repro/serve/ep_decode.py:183``).

    Decode batches are tiny, so unlike the training zebra hop the token
    batch stays REPLICATED over the EP ranks: every rank routes the full
    batch, takes its own ceil(T / ep_size) token stripe (zero-padded),
    capacity-packs it in PLACEMENT slot order (``eslot[idx]``), and
    exchanges capacity chunks with all-to-alls as zebra's alltoall mode
    does. The rank's grouped FFN (``ops.moe_ffn_packed_multi``,
    small_m=None) picks its route at the rank's group count E / ep_size.
    The stripes' results are all-gathered back to the replicated layout.
    ``ffn_params`` holds the rank's E_loc experts (:func:`place_params`).

    aux carries ``ep_counts`` [E]: routed copies per GLOBAL expert id with
    ``mask`` (the live-slot mask) applied: the RoutingEMA's input. x is
    the same on every rank, so counts and router losses need no sum."""
    from repro_torch.kernels import ops as kops
    group = group if group is not None else EPGroup()
    E, k = cfg.n_experts, cfg.top_k
    n_ep = ep.ep_size
    if group.size != n_ep:
        raise ValueError(f"ep_size {n_ep} != EP group size {group.size}")
    E_loc = E // n_ep
    Q = max(int(ep.n_chunks), 1)
    cd = run.policy.compute_dtype

    def moe_fn(ffn, x, mask):
        T, d = x.shape
        weights, idx, aux = modules.moe_route(ffn["router"], cfg,
                                              run.policy, x)
        # Routed-copy histogram in GLOBAL ids, dead slots masked out.
        counts = torch.zeros(E, dtype=torch.float32, device=x.device)
        counts.index_add_(0, idx.reshape(-1).long(),
                          mask.float().repeat_interleave(k))
        aux = dict(aux, ep_counts=counts)
        # Placement remap: route in expert ids, dispatch in slot ids.
        slot_idx = ffn["eslot"].long()[idx.long()]
        Tp = -(-T // n_ep)
        pad = n_ep * Tp - T
        if pad:
            # Pad rows are zero -> zero FFN output -> inert in the combine.
            x = torch.cat([x, x.new_zeros((pad, d))])
            slot_idx = torch.cat([slot_idx, slot_idx.new_zeros((pad, k))])
            weights = torch.cat([weights, weights.new_zeros((pad, k))])
        rows = slice(group.rank * Tp, (group.rank + 1) * Tp)
        x_s, i_s, w_s = x[rows], slot_idx[rows], weights[rows]
        # Dropless: a token's top-k experts are distinct, so one expert
        # receives at most Tp copies from this stripe -> C >= Tp suffices.
        C, Cq = kops.chunk_capacity(max(_round_up(Tp, 8), 8), Q)
        buf, meta = _pack(x_s, i_s, E, C)       # [E, C, d], slot order
        rem = buf.reshape(n_ep, E_loc, C, d)
        recv = [group.all_to_all(rem[:, :, q * Cq:(q + 1) * Cq])
                for q in range(Q)]
        outs = []
        for q in range(Q):
            r = recv[q].transpose(0, 1).reshape(E_loc, n_ep * Cq, d)
            # small_m=None: the route is picked at the rank's group count
            (o,) = kops.moe_ffn_packed_multi(
                [r], [ffn["wi_gate"].to(cd)], [ffn["wi_up"].to(cd)],
                [ffn["wo"].to(cd)], small_m=None)
            o = o.reshape(E_loc, n_ep, Cq, d).transpose(0, 1)
            outs.append(group.all_to_all(o))
        back = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
        y_s = _unpack(back.reshape(E, C, d), meta, w_s, Tp)
        return group.all_gather(y_s)[:T], aux

    return moe_fn


def moe_override_for(moe_fn: Callable, active=None) -> Callable:
    """Adapt the EP moe_fn to the stack's ``moe_override`` contract.

    ``active`` is the decode step's live-slot mask [B] (a tensor on the
    step's device); None means every row is live (prefill), whose
    histogram counts every prefill token, but prefill registers no
    ``ep_counts`` in its aux accumulator, so only decode feeds the EMA."""
    def override(ffn_params, u):
        B, S, d = u.shape
        if active is None:
            m = torch.ones(B * S, dtype=torch.float32, device=u.device)
        else:
            m = active.float().repeat_interleave(S)
        y2, aux = moe_fn(ffn_params, u.reshape(-1, d), m)
        return y2.reshape(u.shape).to(u.dtype), aux
    return override


# ---------------------------------------------------------------------------
# Per-device HBM accounting (admission inputs, DESIGN.md §11.3)
# ---------------------------------------------------------------------------

def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def expert_weight_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Exact expert-stack residency (wi_gate + wi_up + wo over every MoE
    layer), reckoned from the param specs' shapes without allocating (the
    JAX package reads its abstract param tree)."""
    total = 0

    def walk(node):
        nonlocal total
        if isinstance(node, dict):
            if "router" in node and "wi_gate" in node:
                total += sum(_numel(node[k].shape) for k in EXPERT_KEYS)
            else:
                for v in node.values():
                    walk(v)

    walk(stack.param_specs(cfg))
    return total * dtype_bytes


def model_weight_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    return sum(_numel(s.shape)
               for s in stack.flat_param_specs(cfg).values()) * dtype_bytes


def ep_hbm_budget(cfg: ModelConfig, *, hbm_bytes: int, ep_size: int,
                  page_size: int, dtype_bytes: int = 2) -> dict:
    """Admission vs per-device HBM: what EP sharding frees and how many
    decode pool pages fit in it. The scheduler's pool (`BlockAllocator`
    geometry) should be sized from ``pool_pages_ep``: replicated expert
    weights were charged against the same budget."""
    from repro_torch.core import profiler as prof
    experts = expert_weight_bytes(cfg, dtype_bytes)
    dense = model_weight_bytes(cfg, dtype_bytes) - experts
    shard = -(-experts // max(ep_size, 1))
    page = max(prof.kv_page_bytes(cfg, page_size), 1)

    def pages(resident):
        return max(int((hbm_bytes - resident) // page), 0)

    return {
        "expert_bytes_total": experts,
        "expert_bytes_per_device": shard,
        "hbm_reduction": experts / max(shard, 1),
        "pool_pages_replicated": pages(dense + experts),
        "pool_pages_ep": pages(dense + shard),
    }


# ---------------------------------------------------------------------------
# EP continuous-batching engine: placement lifecycle + online re-balance
# ---------------------------------------------------------------------------

def balanced_placement(hist, ep_size: int, speeds=None) -> tuple:
    """Histogram-aware placement via the serving Asym-EA extension:
    greedy LPT over per-expert load with fixed shard cardinality. Equal
    ``speeds`` (the engine's default: it has no device classes)
    load-balances; the planner passes per-rank HBM bandwidths for the
    hot-on-strong / cold-on-weak assignment."""
    E = len(hist)
    if E % ep_size:
        raise ValueError(f"{ep_size} shards do not divide {E} experts")
    sp = list(speeds) if speeds is not None else [1.0] * ep_size
    return asym_ea_place([float(h) for h in hist], sp, E // ep_size)


class EPContinuousBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching over EP-sharded expert weights (DESIGN.md §11).

    Takes UNPLACED (replicated-layout) params and places them here: the
    compute-dtype copy (``stack.compute_params``) permuted, with ``eslot``
    injected, this rank's slots kept (:func:`place_params` under the
    program's EP group) and, on a mesh, the other leaves cut to the rank's
    blocks (``ContinuousProgram.prepare``). Every decode step returns the routed-copy
    histogram, which feeds a :class:`RoutingEMA`; with ``rebalance_every``
    set, when the EMA drifts past ``drift_threshold`` (total variation
    against the histogram the current placement was computed from),
    experts are re-placed through ``placer`` (hist -> placement; default
    the load-balanced :func:`balanced_placement`). A re-balance swaps ONLY
    ``self.params``: KV pools, page tables and slot state stay, so
    generation continues token-exact across it."""

    def __init__(self, program: ContinuousProgram, params,
                 scheduler: Scheduler, *, placement=None,
                 placer: Callable = None, **kw):
        ep = program.ep
        assert ep is not None, "program was built without ep=EPDecodeConfig"
        self.epcfg = ep
        # One compute-dtype copy, made at load; each placement permutes it
        # (the same bits as permuting the f32 params and casting at use).
        self._base_params = stack.compute_params(params, program.run.policy)
        self.placer = placer
        E = program.cfg.n_experts
        self.ema = RoutingEMA(E, decay=ep.ema_decay)
        self.n_rebalances = 0
        self._steps_since_check = 0
        pl = placement if placement is not None else ep.placement
        if pl is None:
            pl = round_robin_placement(E, ep.ep_size)
        self.placement = tuple(tuple(int(e) for e in s) for s in pl)
        self._placement_hist = np.full((E,), 1.0 / E)
        self._program = program  # _place runs before super().__init__
        placed = self._place(self.placement)
        super().__init__(program, placed, scheduler, **kw)

    def _place(self, placement):
        """The rank's blocks of the params placed under ``placement``."""
        return self._program.prepare(place_params(
            self._base_params, self._program.cfg, placement,
            self._program.ep_group))

    def _on_ep_counts(self, counts) -> None:
        self.ema.update(counts)
        ep = self.epcfg
        if ep.rebalance_every <= 0:
            return
        self._steps_since_check += 1
        if self._steps_since_check < ep.rebalance_every:
            return
        self._steps_since_check = 0
        if self.ema.drift(self._placement_hist) <= ep.drift_threshold:
            return
        hist = self.ema.merged()
        new = self.placer(hist) if self.placer \
            else balanced_placement(hist, ep.ep_size)
        self.rebalance(new)

    def rebalance(self, placement) -> bool:
        """Re-place experts mid-trace. Only the param tree moves; decode
        state survives, so live requests continue token-exact."""
        placement = tuple(tuple(int(e) for e in s) for s in placement)
        self._placement_hist = self.ema.merged()
        if placement == self.placement:
            return False
        self.params = None  # the old placement's stacks go first
        self.params = self._place(placement)
        self.placement = placement
        self.n_rebalances += 1
        return True
