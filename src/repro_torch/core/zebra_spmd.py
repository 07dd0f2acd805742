"""Zebra parallelism, single-program engine (mirror of
``repro/core/zebra_spmd.py``).

The paper's zebra parallelism overlaps attention of microbatch k with the
experts (dispatch, expert FFN, combine) of microbatch k-1, with CUDA
streams. The JAX package expresses the two halves as data-independent
steps of one program and leaves the overlap to XLA's scheduler; the port
schedules it itself, as the paper did: :func:`make_layer_override` runs
the attention halves on one CUDA stream and the expert halves on a second
one, ordered by events.

Two expert-parallel dispatch modes (``ZebraConfig.mode``), both over
capacity-packed [E, C, d] buffers (GShard drops beyond the capacity C):

* ``"replicated"``: every EP rank holds the whole token batch; each rank
  selects the token copies routed to its own experts into E_loc + 1 groups
  (the last one the drop group), runs its experts, and the partial outputs
  are summed over the ranks (an all-reduce).
* ``"alltoall"``: each rank holds its own tokens; the packed buffer is
  exchanged with all-to-alls in ``n_chunks`` capacity chunks (dispatch)
  and ``n_chunks_combine`` sub-chunks (combine); experts [0,
  offload_experts) stay replicated on every rank, their rows folded into
  chunk 0's one grouped call (``ops.moe_ffn_packed_multi``).

The EP ranks are an :class:`EPGroup`: with no process group (or one of
size 1) the all-to-all and the all-reduce are the identity; with n ranks
they are ``torch.distributed`` collectives that autograd differentiates
(the all-reduce's gradient is the all-reduce of the cotangents, the
all-to-all's the reverse all-to-all). Under that convention a rank's
gradients are the partial sums of the global ones: the loss of a rank
counts a replicated output 1/n times, and the gradients of replicated
values (the router, the offloaded experts, replicated inputs) are summed
over the ranks, as the JAX package's ``shard_map`` transposes them.

Both modes equal ``modules.apply_moe`` up to capacity drops (equality
holds at ``capacity_factor >= n_experts / top_k``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import modules
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.modules import RunConfig
from repro_torch.sharding import collectives as C


@dataclasses.dataclass(frozen=True)
class ZebraConfig:
    """The JAX package's ``ZebraConfig``, field for field (the driver
    prints them all). ``ep_axis`` and ``batch_axes`` name mesh axes, read
    on a mesh (``make_ep_moe(mesh=)``); without one the EP ranks are the
    :class:`EPGroup` a caller builds."""
    num_microbatches: int = 4
    mode: str = "replicated"  # replicated | alltoall
    ep_axis: str = "model"
    batch_axes: tuple = ("data",)  # axes the token batch is sharded over
    capacity_factor: float = 1.25
    pipeline: bool = True  # False -> sequential EP (no microbatches)
    # Chunked dispatch (alltoall mode): the [E, C, d] dispatch buffer is
    # split into n_chunks capacity slices, each with its own all-to-all.
    n_chunks: int = 1
    # Combine-side chunk count (alltoall mode); None: 2 * n_chunks when
    # n_chunks > 1, else 1. A multiple of n_chunks.
    n_chunks_combine: Optional[int] = None
    # Asym-EA offload (alltoall mode): experts [0, offload_experts) are
    # replicated on every rank; their tokens skip the all-to-all and their
    # rows join chunk 0's grouped call.
    offload_experts: int = 0


MODES = ("replicated", "alltoall")

# What the engine chose and dropped since the last reset_stats(True),
# off by default: the capacities and packed-route row tiles (host ints)
# and, on the device, the token copies routed to this rank's experts and
# those kept (two sums per pack; recomputed packs count again, so read the
# share, not the totals).
STATS: dict = {}
_STATS_ON = [False]


def reset_stats(enable: bool = True) -> None:
    """Clear :data:`STATS` and turn its collection on (or off)."""
    STATS.clear()
    _STATS_ON[0] = enable


def read_stats() -> dict:
    """{"capacity": [...], "block_m": [...], "copies": n, "kept": n,
    "dropped_share": x} (synchronizes with the device)."""
    if not STATS:
        return {}
    copies, kept = int(STATS["copies"]), int(STATS["kept"])
    return {"capacity": sorted(STATS["capacity"]),
            "block_m": sorted(STATS["block_m"]), "copies": copies,
            "kept": kept, "dropped_share": 1.0 - kept / max(copies, 1)}


def _record(C: int, block_ms, copies, kept) -> None:
    STATS.setdefault("capacity", set()).add(C)
    STATS.setdefault("block_m", set()).update(block_ms)
    for key, n in (("copies", copies), ("kept", kept)):
        STATS[key] = STATS.get(key, 0) + n


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(T: int, cfg: ModelConfig, zcfg: ZebraConfig) -> int:
    """Per-expert capacity of T tokens: round_up(int(T k / E cf), 8), at
    least 8 (zebra_spmd.py:201, :230)."""
    return max(_round_up(int(T * cfg.top_k / cfg.n_experts
                             * zcfg.capacity_factor), 8), 8)


# ---------------------------------------------------------------------------
# Local capacity packing (shared by both modes)
# ---------------------------------------------------------------------------

def _pack(x, idx, E: int, C: int):
    """Pack tokens into fixed [E, C, d] buffers by routed expert.

    x: [T, d]; idx: [T, k]. Returns (buf [E, C, d], meta). The copies of
    each expert are kept in stable (token, k) order; those beyond C are
    dropped (residual passthrough, GShard semantics). Every d-wide move is
    a gather driven by an index map; dropped copies write the map's trash
    slot E * C, the only duplicate index, which is cut off."""
    T, d = x.shape
    k = idx.shape[1]
    dev = x.device
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    counts = modules._bincount(flat, E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < C
    slot = sorted_e * C + torch.where(keep, pos_in_e, 0)
    tok = order // k
    slot_or_trash = torch.where(keep, slot, E * C)
    idx_map = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    idx_map = idx_map.index_put_((slot_or_trash,), tok)[:E * C]
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    buf = x_pad[idx_map]  # [E*C, d] gather; empty slots read the zero row
    return buf.reshape(E, C, d), (tok, slot, keep, order)


def _pack_at(x, idx, E: int, C: int, offsets):
    """:func:`_pack` of one block of a batch whose earlier blocks hold
    ``offsets[e]`` copies of expert e (int64 [E]): this block's copies of
    e take the slots from ``offsets[e]`` on, in stable (token, k) order,
    and those at or past C are dropped, so the blocks of a batch packed
    in turn keep the copies one pack of the whole batch keeps, in its
    slots. Returns (buf [E, C, d], meta) as :func:`_pack`; with zero
    offsets it is :func:`_pack`, bit for bit."""
    T, d = x.shape
    k = idx.shape[1]
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    counts = modules._bincount(flat, E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = (torch.arange(T * k, device=x.device) - starts[sorted_e]
                + offsets[sorted_e])
    keep = pos_in_e < C
    slot = sorted_e * C + torch.where(keep, pos_in_e, 0)
    tok = order // k
    idx_map = torch.full((E * C + 1,), T, dtype=torch.int64, device=x.device)
    idx_map = idx_map.index_put_((torch.where(keep, slot, E * C),),
                                 tok)[:E * C]
    buf = torch.cat([x, x.new_zeros((1, d))])[idx_map]
    return buf.reshape(E, C, d), (tok, slot, keep, order)


def _unpack(buf, meta, weights, T: int):
    """Weighted combine back to [T, d]: a gather of each copy's row, times
    its router weight (0 for dropped copies), the inverse permutation back
    to token-major order and a sum over the k copies (no d-wide
    scatter)."""
    tok, slot, keep, order = meta
    d = buf.shape[-1]
    k = order.shape[0] // T
    vals = buf.reshape(-1, d)[slot]  # [T*k, d], expert-sorted
    w = weights.reshape(-1)[order]
    vals = vals * torch.where(keep, w, 0.0).to(vals.dtype)[:, None]
    inv = torch.argsort(order)  # inverse permutation
    return vals[inv].reshape(T, k, d).sum(1)


def _experts_dense(wi_gate, wi_up, wo, buf, cd):
    """Per-expert FFN over packed buffers, buf: [E_loc, C, d]. The JAX
    package's ``use_kernel`` branch: the capacity-packed buffer IS the
    tile-aligned packed domain, so it feeds ``ops.moe_ffn_packed`` (the
    grouped GLU and down-projection kernels) with no sort, no scatter and
    no gather. The port has only that route (its kernel wrappers run their
    plain versions on CPU tensors), never the batched einsum."""
    return kops.moe_ffn_packed(buf, wi_gate.to(cd), wi_up.to(cd),
                               wo.to(cd))


# ---------------------------------------------------------------------------
# Expert-parallel ranks and placement
# ---------------------------------------------------------------------------

class EPGroup:
    """The expert-parallel ranks: a ``torch.distributed`` process group,
    or none (one rank). Collectives are autograd-aware; on one rank they
    are the identity."""

    def __init__(self, group=None):
        self.group = group
        if group is None:
            self.size, self.rank = 1, 0
        else:
            import torch.distributed as dist
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)

    def all_reduce(self, t):
        """Sum over the ranks; its gradient sums the cotangents."""
        return C.all_reduce(t, self.group)

    def all_to_all(self, t):
        """t: [n, ...]; slice j goes to rank j, slice j of the result came
        from rank j (``lax.all_to_all`` split_axis=0, concat_axis=0,
        tiled=False); its gradient is the reverse exchange."""
        if self.size == 1:
            return t
        from torch.distributed.nn import functional as dnn
        t = t.contiguous()
        C.launched("all_to_all")
        return dnn.all_to_all_single(torch.empty_like(t), t,
                                     group=self.group)

    def all_gather(self, t):
        """Every rank's t concatenated along dim 0 in rank order
        (``lax.all_gather`` tiled=True); its gradient is each rank's slice
        of the summed cotangents."""
        return C.all_gather(t, 0, self.group)


def ep_ffn_params(ffn, n_loc: int, E_loc: int, ep: EPGroup,
                  local: bool = False) -> dict:
    """The EP placement of a MoE FFN's params (the JAX package's
    ``sharding.rules.ep_ffn_specs``) taken from the whole param dict:
    the router replicated; rank r's remote experts [n_loc + r E_loc,
    n_loc + (r + 1) E_loc); with an offload, experts [0, n_loc) under the
    ``*_loc`` keys, replicated on every rank. ``local``: the stacks hold
    this rank's experts already (the mesh program's shards over "model"),
    and are used as they are."""
    if local:
        return ffn
    fp = {"router": ffn["router"]}
    lo = n_loc + ep.rank * E_loc
    for key in ("wi_gate", "wi_up", "wo"):
        w = ffn[key]
        if n_loc:
            fp[key + "_loc"] = w[:n_loc]
        # the whole stack as it is: a full-range slice would cost a
        # zero-filled full-size gradient and a copy in the backward
        fp[key] = w if (lo, E_loc) == (0, w.shape[0]) else w[lo:lo + E_loc]
    return fp


# ---------------------------------------------------------------------------
# Expert-parallel MoE FFN
# ---------------------------------------------------------------------------

def make_ep_moe(cfg: ModelConfig, run: RunConfig, zcfg: ZebraConfig, *,
                group=None, mesh=None) -> Callable:
    """Returns moe_fn(ffn_params, x2d [T, d]) -> (y2d, aux) on this rank;
    in replicated mode ``moe_fn(..., reduce=f)`` returns ``f`` of the
    rank's partial output in place of its all-reduce.

    ``ffn_params`` is the layer's whole MoE param dict (every expert); the
    rank takes its placement (:func:`ep_ffn_params`). ``group``: the EP
    process group (None: one rank). In replicated mode every rank passes
    the same x2d; in alltoall mode each rank its own tokens.

    ``mesh`` (``launch.mesh.Mesh``; the JAX package's ``shard_map`` over
    it): the EP ranks are the ``zcfg.ep_axis`` group, and x2d is this
    rank's rows of the microbatch over ``zcfg.batch_axes``. The aux
    losses are averaged over the batch shards (the JAX package's
    ``pmean``), and without an offload the expert stacks given are this
    rank's own. In alltoall mode a batch not split over the EP axis is
    split there by token blocks, and the outputs gathered back."""
    if zcfg.mode not in MODES:
        raise ValueError(f"unknown zebra mode {zcfg.mode!r}")
    ep = EPGroup(mesh.group(zcfg.ep_axis) if mesh is not None else group)
    E, k, n_ep = cfg.n_experts, cfg.top_k, ep.size
    n_loc = zcfg.offload_experts if zcfg.mode == "alltoall" else 0
    E_rem = E - n_loc
    if not 0 <= n_loc < E:
        raise ValueError(f"offload_experts {n_loc} out of range for E={E}")
    if E_rem % n_ep:
        raise ValueError(f"remote experts {E_rem} must divide over {n_ep} "
                         f"ranks")
    E_loc = E_rem // n_ep
    Q = max(int(zcfg.n_chunks), 1)
    Qc = zcfg.n_chunks_combine if zcfg.n_chunks_combine \
        else (2 * Q if Q > 1 else 1)
    Qc = max(int(Qc), Q)
    if Qc % Q:
        raise ValueError(f"n_chunks_combine {Qc} must be a multiple of "
                         f"n_chunks {Q}")
    cd = run.policy.compute_dtype
    # the batch shards the aux losses are averaged over, and whether this
    # rank must cut its own token block for the EP axis (a mesh's only)
    ba, split = (), False
    if mesh is not None:
        ba = tuple(zcfg.batch_axes)
        if zcfg.mode == "alltoall" and zcfg.ep_axis not in ba:
            ba, split = ba + (zcfg.ep_axis,), n_ep > 1
        batch = EPGroup(mesh.group(ba))

    def batch_mean(aux):
        if mesh is None or batch.size == 1:
            return aux
        return {key: batch.all_reduce(v) / batch.size
                for key, v in aux.items()}

    def replicated(ffn, x, reduce=None):  # x: [T, d], the same everywhere
        T, d = x.shape
        weights, idx, aux = modules.moe_route(ffn["router"], cfg,
                                              run.policy, x)
        e_off = ep.rank * E_loc
        local = (idx >= e_off) & (idx < e_off + E_loc)
        idx_loc = torch.where(local, idx - e_off, E_loc)  # E_loc = drop
        C = capacity(T, cfg, zcfg)
        buf, meta = _pack(x, idx_loc, E_loc + 1, C)
        if _STATS_ON[0]:
            mine = meta[1] < E_loc * C  # copies routed to this rank
            _record(C, [kops.packed_block_m([C])], mine.sum(),
                    (meta[2] & mine).sum())
        out = _experts_dense(ffn["wi_gate"], ffn["wi_up"], ffn["wo"],
                             buf[:E_loc], cd)
        out = torch.cat([out, out.new_zeros((1, C, d))])
        y = _unpack(out, meta, weights, T)
        # sum the partial expert outputs (``reduce``: the caller's sum)
        return (reduce or ep.all_reduce)(y), batch_mean(aux)

    def ffn_packed(ffn, bufs, keys):
        ws = [[ffn[w + s].to(cd) for s in keys]
              for w in ("wi_gate", "wi_up", "wo")]
        return kops.moe_ffn_packed_multi(bufs, *ws)

    def alltoall(ffn, x):  # x: [T, d], this rank's tokens
        T, d = x.shape
        weights, idx, aux = modules.moe_route(ffn["router"], cfg,
                                              run.policy, x)
        # aux losses are means over the token dim: average over the ranks
        aux = batch_mean(aux) if mesh is not None else \
            {key: ep.all_reduce(v) / n_ep for key, v in aux.items()}
        # Capacity padded so it splits into Qc combine sub-chunks of a
        # multiple of 8 rows; each dispatch chunk covers Qc / Q of them.
        C, Cqc = kops.chunk_capacity(capacity(T, cfg, zcfg), Qc)
        Cq = C // Q
        buf, meta = _pack(x, idx, E, C)  # [E, C, d]
        if _STATS_ON[0]:
            _record(C, {kops.packed_block_m(
                [C, n_ep * Cq] if q == 0 and n_loc else [n_ep * Cq])
                for q in range(Q)}, T * k, meta[2].sum())
        loc = buf[:n_loc]                # offloaded experts
        rem = buf[n_loc:].reshape(n_ep, E_loc, C, d)
        # Dispatch: every chunk's all-to-all issued before any expert FFN.
        recv = [ep.all_to_all(rem[:, :, q * Cq:(q + 1) * Cq])
                for q in range(Q)]
        outs = []
        for q in range(Q):
            r = recv[q].transpose(0, 1).reshape(E_loc, n_ep * Cq, d)
            if q == 0 and n_loc:
                # local + remote experts in ONE grouped call per direction
                out_l, o = ffn_packed(ffn, [loc, r], ("_loc", ""))
            else:
                (o,) = ffn_packed(ffn, [r], ("",))
            # Combine: chunk q's reverse all-to-alls, in Qc / Q sub-chunks
            o = o.reshape(E_loc, n_ep, Cq, d).transpose(0, 1)
            for s in range(Qc // Q):
                outs.append(ep.all_to_all(o[:, :, s * Cqc:(s + 1) * Cqc]))
        back = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
        out_full = back.reshape(E_rem, C, d)
        if n_loc:
            out_full = torch.cat([out_l.to(out_full.dtype), out_full])
        return _unpack(out_full, meta, weights, T), aux

    fn = replicated if zcfg.mode == "replicated" else alltoall
    local = mesh is not None and n_loc == 0

    def moe_fn(ffn_params, x2d, **kw):
        ffn = ep_ffn_params(ffn_params, n_loc, E_loc, ep, local=local)
        if not split:
            return fn(ffn, x2d, **kw)
        n = x2d.shape[0] // n_ep
        y, aux = fn(ffn, x2d[ep.rank * n:(ep.rank + 1) * n])
        return ep.all_gather(y), aux

    return moe_fn


# ---------------------------------------------------------------------------
# Zebra-pipelined MoE layer (the layer_override of models/stack.py)
# ---------------------------------------------------------------------------

class _Streams:
    """The two CUDA streams of one override: attention on ``main``, the
    stream current at the override's first call on the card (the
    caller's); experts on ``side``, created then. The remat recompute may
    enter from a backward node's stream (the autograd engine runs each
    backward op on its forward op's stream); each half still runs on its
    own stream, so every recomputed tensor lies on the stream of the
    backward op that reads it."""

    def __init__(self):
        self.main = self.side = None

    def open(self, x):
        if self.side is None:
            self.main = torch.cuda.current_stream(x.device)
            self.side = torch.cuda.Stream(x.device)
        return self.main, self.side


def make_layer_override(cfg: ModelConfig, run: RunConfig, zcfg: ZebraConfig,
                        *, mesh=None, group=None,
                        streams: bool = True) -> Callable:
    """The stack-level layer override implementing zebra parallelism:
    override(layer_params, spec, x [B, S, d], positions, seq=None) -> (y,
    aux).

    R microbatches (``num_microbatches`` fitted down to a divisor of B):
    attn(mb 0), then for k = 1..R-1 experts(mb k-1) || attn(mb k), then
    experts(mb R-1); aux losses averaged over the microbatches. On CUDA
    tensors the expert halves run on a second stream that waits on the
    attention stream after attn(mb k-1), and the attention stream waits
    on it before the microbatches are concatenated. ``streams=False``
    runs the same order on one stream (a test's reference). ``mesh``:
    the mesh program's (see :func:`make_ep_moe`); x is this rank's rows,
    microbatch k its k-th block of rows. ``seq`` (a ``train.step.SeqPlan``
    over the EP axis; replicated mode): y is this rank's seq block [B,
    ceil(S / M), d], each microbatch's expert sum over the ranks and the
    cut to the block fused into one reduce-scatter."""
    moe_fn = make_ep_moe(cfg, run, zcfg, group=group, mesh=mesh)
    two = _Streams()

    def override(layer_params, spec: LayerSpec, x, positions, seq=None):
        B, S, d = x.shape
        R = zcfg.num_microbatches if zcfg.pipeline else 1
        while R > 1 and B % R:
            R -= 1

        def attn_part(mb_x, mb_pos):
            h, _ = modules.apply_mixer_part(layer_params, cfg, run, spec,
                                            mb_x, mb_pos)
            u = modules.apply_norm(layer_params["norm2"], h, run.policy)
            return h, u

        def expert_part(h, u):
            if seq is None:
                y2, aux = moe_fn(layer_params["ffn"], u.reshape(-1, d))
                return h + y2.reshape(h.shape).to(h.dtype), aux
            y2, aux = moe_fn(layer_params["ffn"], u.reshape(-1, d),
                             reduce=lambda y: seq.scatter(y.view(h.shape)))
            return seq.part(h) + y2.to(h.dtype), aux

        if R == 1:
            h, u = attn_part(x, positions)
            return expert_part(h, u)

        xs = x.reshape(R, B // R, S, d)
        ps = positions.reshape(R, B // R, S)
        if not (streams and x.is_cuda):
            hu = attn_part(xs[0], ps[0])
            ys, auxs = [], []
            for kk in range(1, R):
                y_prev, a = expert_part(*hu)
                hu = attn_part(xs[kk], ps[kk])
                ys.append(y_prev)
                auxs.append(a)
            y_last, aux_last = expert_part(*hu)
        else:
            ys, auxs, y_last, aux_last = _two_stream_pipeline(
                two, x, xs, ps, R, attn_part, expert_part)
        y = torch.cat(ys + [y_last])
        # aux losses are per-token means: average them over microbatches
        aux = {key: (torch.stack([a[key] for a in auxs]).sum(0)
                     + aux_last[key]) / R for key in aux_last}
        return y, aux

    return override


def _two_stream_pipeline(two: _Streams, x, xs, ps, R: int, attn_part,
                         expert_part):
    """The zebra order on two CUDA streams. Tensors crossing streams are
    marked with ``record_stream`` so the caching allocator does not hand
    their memory out while the other stream may still read them."""
    main, side = two.open(x)
    entry = torch.cuda.current_stream(x.device)
    if entry != main:  # remat recompute entered from the expert stream
        main.wait_stream(entry)
        x.record_stream(main)

    def on_side(hu):
        side.wait_stream(main)  # after attn(mb k-1), before attn(mb k)
        for t in hu:
            t.record_stream(side)
        with torch.cuda.stream(side):
            y, aux = expert_part(*hu)
        y.record_stream(main)
        for v in aux.values():
            v.record_stream(main)
        return y, aux

    ys, auxs = [], []
    with torch.cuda.stream(main):
        hu = attn_part(xs[0], ps[0])
        for kk in range(1, R):
            y_prev, a = on_side(hu)
            hu = attn_part(xs[kk], ps[kk])
            ys.append(y_prev)
            auxs.append(a)
        y_last, aux_last = on_side(hu)
        main.wait_stream(side)  # the microbatches join on main
    if entry != main:  # the caller's stream joins them
        entry.wait_stream(main)
        for y, aux in zip(ys + [y_last], auxs + [aux_last]):
            for t in (y, *aux.values()):
                t.record_stream(entry)
    return ys, auxs, y_last, aux_last
