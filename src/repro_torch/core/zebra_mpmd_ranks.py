"""The zebra MPMD engine across ranks: the attention group and the expert
lanes as the processes of one ``torch.distributed`` group, the layout of
the JAX engine's two meshes (``repro/core/zebra_mpmd.py:87-117``).

Ranks 0..M-1 are the attention group. Each takes a contiguous block of
B / (R M) rows of every microbatch and holds the attention side,
replicated: embedding, norms, attention blocks, routers and the
offloaded experts [0, n_att). Ranks M..M+N-1 are expert lanes 0..N-1:
lane i holds experts [n_att + i E_lane, n_att + (i+1) E_lane) of every
layer. The loss and the gradients are the one-process engine's
(``core/zebra_mpmd.py``) at any M and N:

* Capacity and drops are global. The capacity comes from the whole
  microbatch. Each attention rank all-gathers the copies routed to each
  expert and packs its own from the slot where the earlier ranks' copies
  end (``zebra_spmd._pack_at``), so the copies kept are those one pack of
  the microbatch keeps, in its slots.
* The hops carry rows only. For each (layer, microbatch) an attention
  rank sends each lane a header: the first slot and the kept count of
  each of the lane's experts, and its rows in each capacity chunk. Then,
  chunk by chunk, it sends the rows it holds in that chunk. The lane
  writes them into a zeroed [E_lane, C_chunk, d] buffer, the one-process
  lane's chunk row for row, and sends its outputs back over the same
  segments. In the backward the cotangent and the recompute input cross
  in one message, and the lane keeps the segments of the forward. The
  rows of a hop, summed over the attention ranks, are at most the
  reference's E_rem C d.
* The offloaded experts run on each attention rank over its own kept
  rows, in a buffer of the rank's own capacity (its largest kept count,
  rounded as the capacity is); no row is computed twice. Their weight
  gradients join the attention side's sum over the group.
* The loss is the global mean: each rank's NLL sum over the microbatch's
  token count, summed over every rank. ``grads_attn`` is summed over the
  attention group, so every attention rank returns the whole gradient.

Every rank walks the one-process engine's issue order (Theorem 1's
canonical schedule). An attention rank runs A, X and H and its side of
the hops; a lane runs E and its side. Both sides of a pair post their
messages in the order :func:`pair_messages` derives from the issue
order: the header at A(F), the chunks at D(F), the outputs back at E(F),
cotangent and input at C(B), the input gradients back at E(B). A post
out of that order raises, and so does a header whose segments do not
follow the earlier ranks' or whose chunk sizes differ from the lane's.
Each (attention rank, lane) pair has a process group of its own: NCCL on
CUDA, gloo on the CPU. On CUDA a send waits on the compute stream where
it is posted, the compute stream waits on a receive's event where it
reads it (``Work.wait``), and the sizes read on the host (the gathered
counts, the headers) are copied on a stream of their own, so the read
waits for that message only; nothing calls ``torch.cuda.synchronize``.
Rank 0 emits the reference's spans on the ``zebra-mpmd`` track.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core import zebra_spmd as zs
from repro_torch.core.zebra_mpmd import (EXPERT_KEYS, TRACK, ZebraMPMD,
                                         _accumulate, _round_up, _unflatten)
from repro_torch.models import modules
from repro_torch.obs import trace as obs_trace
from repro_torch.pytree import flatten, tree_map

# The task whose walk posts each message, on both sides: (kind, sender).
HOPS = {("A", "F"): ("hdr", "attn"), ("D", "F"): ("F", "attn"),
        ("E", "F"): ("Fb", "lane"), ("C", "B"): ("B", "attn"),
        ("E", "B"): ("Bb", "lane")}


def pair_messages(order, Q: int, live) -> List[tuple]:
    """The messages between one attention rank and one lane, in the order
    both post them: (kind, layer, microbatch, chunk, sender) for each task
    of the issue order that posts a hop, at a layer where the lanes hold
    experts (``live[l]``). The header is one message a (layer,
    microbatch), the data messages one a capacity chunk."""
    out = []
    for task, phase, l, j in order:
        hop = HOPS.get((task, phase))
        if hop is None or not live[l]:
            continue
        kind, sender = hop
        for q in ([None] if kind == "hdr" else range(Q)):
            out.append((kind, l, j, q, sender))
    return out


def side_messages(order, Q: int, live, role: str) -> List[tuple]:
    """:func:`pair_messages` as one side posts them: (op, kind, layer,
    microbatch, chunk), op "send" or "recv", for ``role`` "attn" or
    "lane"."""
    return [("send" if sender == role else "recv", kind, l, j, q)
            for kind, l, j, q, sender in pair_messages(order, Q, live)]


def chunk_rows(starts, kept, q: int, Cq: int, stride: int,
               shift: int) -> torch.Tensor:
    """The rows of one attention rank in capacity chunk q, expert by
    expert and slot by slot: expert e (its rank's copies at slots
    [starts[e], starts[e] + kept[e])) gives each of its slots p in [q Cq,
    (q+1) Cq) as ``e * stride + p + shift``. Both sides of a hop index
    its rows with it, the attention rank into its [E, C] slots, the lane
    into its [E_lane, C_chunk] chunk."""
    out = []
    for e, (s, k) in enumerate(zip(starts, kept)):
        lo, hi = max(s, q * Cq), min(s + k, (q + 1) * Cq)
        out.append(torch.arange(lo, max(lo, hi)) + (e * stride + shift))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64)


class RankGroups:
    """The engine's ranks on the running default process group: ranks
    0..M-1 the attention group, M..M+N-1 expert lanes 0..N-1. Made on
    every rank: it creates the attention group and one group for each
    (attention rank, lane) pair, on every rank in one order. ``device``:
    "cuda" (the rank's current device, ``cuda:LOCAL_RANK`` under
    ``launch_ranks``) or "cpu"."""

    def __init__(self, M: int, N: int, device="cuda"):
        world = dist.get_world_size()
        if M < 1 or N < 1 or M + N != world:
            raise ValueError(
                f"ranks {M}x{N}: {M} attention ranks and {N} expert lanes "
                f"need {M + N} ranks; the process group has {world}")
        self.M, self.N = M, N
        self.rank = dist.get_rank()
        self.role = "attn" if self.rank < M else "lane"
        self.index = self.rank if self.role == "attn" else self.rank - M
        self.attn_group = dist.new_group(list(range(M)))
        self.pairs: Dict[int, object] = {}  # peer's rank -> the pair group
        for a in range(M):
            for i in range(N):
                g = dist.new_group([a, M + i])
                if self.rank in (a, M + i):
                    self.pairs[M + i if self.rank == a else a] = g
        dev = torch.device(device)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dev.type == "cuda" else dev)

    @property
    def peers(self) -> List[int]:
        return sorted(self.pairs)


@dataclasses.dataclass
class _Layout:
    """Where an attention rank's copies of one (layer, microbatch) sit: the
    capacity C; every rank's routed copies of each expert
    (``counts``, [M][E]); the first slot of this rank's copies of each
    expert (``off``, and ``offsets`` on the device) and its kept counts;
    the slots of its rows in chunk q of lane i (``rows[(q, i)]``, into [E
    C]); and for the offloaded experts their slots and their places in the
    rank's own [n_att, C_loc] buffer (``loc``: slots, places, C_loc)."""
    C: int
    counts: list
    off: list
    offsets: torch.Tensor
    kept: list
    rows: dict
    loc: Optional[tuple]


class ZebraMPMDRanks(ZebraMPMD):
    """The zebra MPMD engine with its attention ranks and expert lanes as
    the ranks of the running default process group (``ranks``; module
    docstring). Built on every rank with the same arguments; its
    ``shard_params`` keeps this rank's part and its ``train_step`` runs
    this rank's tasks."""

    def __init__(self, cfg, run, ranks: RankGroups,
                 num_microbatches: int = 2, offload: Optional[tuple] = None,
                 capacity_factor: Optional[float] = None, n_chunks: int = 1):
        super().__init__(cfg, run, [ranks.device], [ranks.device] * ranks.N,
                         num_microbatches, offload, capacity_factor,
                         n_chunks, streams=False)
        self.ranks = ranks
        self.M = ranks.M
        self.live = [self.lane_experts(l) > 0 for l in range(cfg.n_layers)]
        self.messages = side_messages(self.order, self.Q, self.live,
                                      ranks.role)
        self._read_stream = None
        # of the last step: bytes sent in each hop, {(kind, l, j): n}; the
        # messages and bytes by (op, kind); an attention rank's routed
        # copies of every rank, {(l, j): [M][E]}
        self.hop_bytes: Dict[tuple, int] = {}
        self.traffic: Dict[tuple, list] = {}
        self.routed: Dict[tuple, list] = {}

    def describe(self) -> List[dict]:
        """Each rank's role and, per layer, the experts it holds."""
        M, N, L = self.ranks.M, self.ranks.N, self.cfg.n_layers
        out = [{"rank": a, "role": "attention", "rows": f"block {a} of {M}",
                "experts": [[0, self.plan.n_attn_experts(l)]
                            for l in range(L)]} for a in range(M)]
        for i in range(N):
            spans = []
            for l in range(L):
                lo = self.plan.n_attn_experts(l) + i * self.lane_experts(l)
                spans.append([lo, lo + self.lane_experts(l)])
            out.append({"rank": M + i, "role": f"lane {i}",
                        "experts": spans})
        return out

    # ------------------------------------------------------------------
    # Placement
    # ------------------------------------------------------------------

    def shard_params(self, params):
        """This rank's part of a fused param tree, copied onto its device
        (the fused tree can be dropped): (attn_side, None) on an attention
        rank, as the one-process engine places it; (None, exp_layers) on
        lane i, exp_layers[l] = [its experts of layer l]."""
        dev = self.ranks.device
        blocks = params["blocks"]["pos0"]

        def own(t):
            return t.to(dev, copy=True)
        if self.ranks.role == "lane":
            i = self.ranks.index
            layers = []
            for l in range(self.cfg.n_layers):
                El = self.lane_experts(l)
                lo = self.plan.n_attn_experts(l) + i * El
                layers.append([{k: own(blocks["ffn"][k][l, lo:lo + El])
                                for k in EXPERT_KEYS}])
            return None, layers
        attn_side = {k: tree_map(own, params[k])
                     for k in ("embed", "final_norm", "lm_head")
                     if k in params}
        attn_layers = []
        for l in range(self.cfg.n_layers):
            lp = tree_map(lambda x: x[l], blocks)
            n_att = self.plan.n_attn_experts(l)
            ffn = lp.pop("ffn")
            lp["ffn"] = {"router": ffn["router"],
                         **{k: ffn[k][:n_att] for k in EXPERT_KEYS}}
            attn_layers.append(tree_map(own, lp))
        attn_side["layers"] = attn_layers
        return attn_side, None

    # ------------------------------------------------------------------
    # Stage programs of an attention rank
    # ------------------------------------------------------------------

    def route(self, p_layer, x, positions):
        """Attention block, norm and router over this rank's rows: (h,
        u2, weights, idx)."""
        cfg, run = self.cfg, self.run
        h, _ = modules.apply_mixer_part(p_layer, cfg, run, self.spec, x,
                                        positions)
        u = modules.apply_norm(p_layer["norm2"], h, run.policy)
        u2 = u.reshape(-1, u.shape[-1])
        weights, idx, _aux = modules.moe_route(p_layer["ffn"]["router"], cfg,
                                               run.policy, u2)
        return h, u2, weights, idx

    def attn_route(self, p_layer, x, positions, lay: _Layout):
        """The one-process engine's attn_route over this rank's rows, packed
        into the microbatch's [E, C, d] slots from ``lay.offsets`` on."""
        h, u2, weights, idx = self.route(p_layer, x, positions)
        buf, meta = zs._pack_at(u2, idx, self.cfg.n_experts, lay.C,
                                lay.offsets)
        return h, buf, weights, idx, meta

    def head_loss(self, p, x, targets):
        """This rank's share of the microbatch's mean NLL: its NLL sum over
        the microbatch's token count."""
        policy = self.run.policy
        xn = modules.apply_norm(p["final_norm"], x, policy)
        logits = modules.apply_unembedding(p["embed"], p.get("lm_head"),
                                           self.cfg, policy, xn)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
        return nll.sum() / (nll.numel() * self.ranks.M)

    # ------------------------------------------------------------------
    # Messages
    # ------------------------------------------------------------------

    def _post(self, st, op, kind, l, j, q, peer, t):
        """Post one message to or from ``peer`` on the pair's group, in the
        order both sides derive from the issue order; a receive returns
        (work, tensor)."""
        want = self.messages[st.cursor[peer]] \
            if st.cursor[peer] < len(self.messages) else None
        if want != (op, kind, l, j, q):
            raise RuntimeError(
                f"rank {self.ranks.rank}: {op} {kind} (layer {l}, "
                f"microbatch {j}, chunk {q}) with rank {peer} out of the "
                f"pair's order, which expects {want}")
        st.cursor[peer] += 1
        nbytes = t.numel() * t.element_size()
        tally = st.traffic.setdefault((op, kind), [0, 0])
        tally[0] += 1
        tally[1] += nbytes
        group = self.ranks.pairs[peer]
        if op == "send":
            if kind != "hdr":
                key = (kind, l, j)
                st.hop_bytes[key] = st.hop_bytes.get(key, 0) + nbytes
            st.pending.append((dist.isend(t, peer, group=group), t))
            return None
        return dist.irecv(t, peer, group=group), t

    def _posted(self):
        """An event on the compute stream marking what is queued there now
        (None off CUDA): the host read of a message posted before it waits
        on it, not on the compute queued later."""
        if self.ranks.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.ranks.device).record_event()

    def _host(self, works, tensors, posted) -> list:
        """``tensors`` stacked, on the host, once ``works`` are done. On
        CUDA the copy runs on a stream of its own that waits on ``posted``
        (the compute stream when the messages were posted: their buffers
        zeroed, the work a backend may queue there) and on the works, not
        on the compute queued since."""
        if self.ranks.device.type != "cuda":
            for w in works:
                w.wait()
            return torch.stack(tensors).tolist()
        if self._read_stream is None:
            self._read_stream = torch.cuda.Stream(self.ranks.device)
        with torch.cuda.stream(self._read_stream):
            self._read_stream.wait_event(posted)
            for w in works:
                w.wait()
            dev = torch.stack(tensors)
            host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            done = self._read_stream.record_event()
        done.synchronize()
        return host.tolist()

    def _zeros(self, *shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.cd,
                           device=self.ranks.device)

    # ------------------------------------------------------------------
    # One training iteration: this rank's tasks in Theorem 1's issue order
    # ------------------------------------------------------------------

    def train_step(self, attn_side, exp_layers, tokens, targets):
        """One training iteration on this rank, called on every rank with
        the same global batch: (loss, grads_attn, grads_exp). The loss is
        the global one on every rank; an attention rank returns the global
        ``grads_attn`` (shaped as its ``attn_side``) and None, lane i None
        and the gradients of its experts (shaped as its ``exp_layers``)."""
        R, M = self.R, self.ranks.M
        B, S_ = tokens.shape
        if B % R or (B // R) % M:
            raise ValueError(
                f"batch {B} in {R} microbatches: {B // R} rows a microbatch "
                f"do not split over {M} attention ranks (the reference's "
                f'P("adata") split needs B / R divisible by M)')
        rows = B // R // M
        st = _RankStep(T=B // R * S_, cursor=dict.fromkeys(self.ranks.peers,
                                                           0))
        attention = self.ranks.role == "attn"
        if attention:
            dev, a = self.ranks.device, self.ranks.index
            block = slice(a * rows, (a + 1) * rows)
            st.toks = tokens.to(dev).reshape(R, B // R, S_)[:, block]
            st.tgts = targets.to(dev).reshape(R, B // R, S_)[:, block]
            st.positions = torch.arange(S_, dtype=torch.int32,
                                        device=dev).expand(rows, S_)
        tasks = self._ATTN if attention else self._LANE
        tr = obs_trace.TRACER
        emit = tr.enabled and self.ranks.rank == 0
        if emit:
            tr.declare_track(TRACK, pid="train")
            base = tr.now * obs_trace.TICK_US  # one microsecond a task
        with torch.no_grad():  # the backward stages re-enable it
            for i, task in enumerate(self.order):
                run = tasks.get(task[:2])
                if run is not None:
                    run(self, task[2], task[3], st, attn_side, exp_layers)
                if emit:
                    for name, i0, args in self.spans.get(i, ()):
                        tr.span_at(TRACK, name, (base + i0) / 1e6,
                                   (base + i + 1) / 1e6, **args)
            return self._finish_ranks(st, attn_side, exp_layers)

    def _finish_ranks(self, st, attn_side, exp_layers):
        for peer, n in st.cursor.items():
            if n != len(self.messages):
                raise RuntimeError(f"rank {self.ranks.rank}: {n} of "
                                   f"{len(self.messages)} messages with "
                                   f"rank {peer} posted")
        for work, _t in st.pending:  # the sends' tensors live until here
            work.wait()
        self.hop_bytes, self.traffic = st.hop_bytes, st.traffic
        scale = 1.0 / self.R

        def scaled(acc, k, like):
            return acc[k].mul_(scale) if k in acc else torch.zeros_like(like)
        dev = self.ranks.device
        loss = torch.zeros(1, dtype=torch.float32, device=dev)
        grads_a = grads_e = None
        if self.ranks.role == "attn":
            loss += sum(st.losses).float() / self.R
            flat = flatten({k: v for k, v in attn_side.items()
                            if k != "layers"})
            grads_a = _unflatten({k: scaled(st.ga, k, v)
                                  for k, v in flat.items()})
            grads_a["layers"] = [
                _unflatten({k: scaled(st.gl[l], k, v)
                            for k, v in flatten(layer).items()})
                for l, layer in enumerate(attn_side["layers"])]
            self._sum_over_attention(grads_a)
        else:
            grads_e = [[{k: scaled(st.ge[l], k, lane[0][k])
                         for k in EXPERT_KEYS}]
                       for l, lane in enumerate(exp_layers)]
        dist.all_reduce(loss)  # the lanes add 0
        return loss[0], grads_a, grads_e

    def _sum_over_attention(self, grads) -> None:
        """Sum every gradient leaf over the attention group, in place (one
        all-reduce a dtype)."""
        if self.ranks.M == 1:
            return
        leaves = list(flatten({k: v for k, v in grads.items()
                               if k != "layers"}).values())
        for layer in grads["layers"]:
            leaves += list(flatten(layer).values())
        by_dtype = collections.defaultdict(list)
        for t in leaves:
            by_dtype[t.dtype].append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=self.ranks.attn_group)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))

    # Attention rank ----------------------------------------------------

    def _layout(self, l, idx, T) -> _Layout:
        """This rank's layout of (l, j): the copy counts all-gathered over
        the attention group and read on the host (an attention rank's one
        host read a (layer, microbatch)), and the index tensors built from
        them, moved to the device in one copy."""
        M, a, E = self.ranks.M, self.ranks.index, self.cfg.n_experts
        C, Cq = self.capacity(T)
        n = modules._bincount(idx.reshape(-1).long(), E).to(torch.int32)
        parts = [torch.zeros_like(n) for _ in range(M)]
        work = dist.all_gather(parts, n, group=self.ranks.attn_group,
                               async_op=True)
        counts = self._host([work], parts, self._posted())
        off = [sum(counts[b][e] for b in range(a)) for e in range(E)]
        kept = [max(0, min(C - off[e], counts[a][e])) for e in range(E)]
        n_att, El = self.plan.n_attn_experts(l), self.lane_experts(l)
        keys = [(q, i) for q in range(self.Q)
                for i in range(self.ranks.N if El else 0)]
        index = [torch.tensor(off, dtype=torch.int64)]
        for q, i in keys:
            lo = n_att + i * El
            index.append(chunk_rows(off[lo:lo + El], kept[lo:lo + El], q,
                                    Cq, C, lo * C))
        loc = None
        if n_att:
            C_loc = max(_round_up(max(kept[:n_att]), 8), 8)
            index.append(chunk_rows(off[:n_att], kept[:n_att], 0, C, C, 0))
            index.append(chunk_rows([0] * n_att, kept[:n_att], 0, C_loc,
                                    C_loc, 0))
        on_dev = torch.cat(index).to(self.ranks.device).split(
            [t.numel() for t in index])
        if n_att:
            loc = (on_dev[-2], on_dev[-1], C_loc)
        return _Layout(C, counts, off, on_dev[0], kept,
                       dict(zip(keys, on_dev[1:1 + len(keys)])), loc)

    def _local(self, lay, rows, n_att):
        """The offloaded experts' rows of a [E C, d] slot tensor, in the
        rank's own [n_att, C_loc, d] buffer."""
        slots, places, C_loc = lay.loc
        d = rows.shape[-1]
        return rows.new_zeros((n_att * C_loc, d)).index_copy_(
            0, places, rows.index_select(0, slots)).view(n_att, C_loc, d)

    def _gather_back(self, st, l, j, ref, local, kind):
        """An [E, C, d] tensor shaped as ``ref``, zero but at this rank's
        slots: the offloaded experts' rows from ``local`` (the rank's own
        buffer) and the lanes' rows received for (l, j)."""
        lay = st.lay[(l, j)]
        out = torch.zeros_like(ref)
        flat = out.view(-1, out.shape[-1])
        if local is not None:
            slots, places, _ = lay.loc
            flat.index_copy_(0, slots, local.reshape(-1, flat.shape[-1])
                             .index_select(0, places).to(flat.dtype))
        for q, per_lane in enumerate(st.recv.pop((kind, l, j), ())):
            for i, (work, t) in enumerate(per_lane):
                work.wait()
                flat.index_copy_(0, lay.rows[(q, i)], t)
        return out

    def _assemble(self, st, l, j):
        """assemble(l, j): the [E, C, d] expert output of this rank's
        slots."""
        return self._gather_back(st, l, j, st.fwd[(l, j)][1],
                                 st.loc.pop((l, j), None), "Fb")

    def _headers(self, l, lay) -> list:
        """Lane i's header from this rank: the first slot and the kept count
        of each of the lane's experts, then its rows in each chunk."""
        n_att, El = self.plan.n_attn_experts(l), self.lane_experts(l)
        out = []
        for i in range(self.ranks.N):
            lo = n_att + i * El
            out.append(torch.tensor(
                lay.off[lo:lo + El] + lay.kept[lo:lo + El]
                + [lay.rows[(q, i)].numel() for q in range(self.Q)],
                dtype=torch.int32, device=self.ranks.device))
        return out

    def _a_fwd(self, l, j, st, attn_side, exp_layers):
        if l == 0:
            x = self.embed(attn_side["embed"], st.toks[j])
        else:
            h, _buf, w, _idx, meta = st.fwd[(l - 1, j)]
            out_full = st.out_full[(l - 1, j)] = self._assemble(st, l - 1, j)
            x = self.combine(h, out_full, w, meta)
        st.x[(l, j)] = x
        h, u2, w, idx = self.route(attn_side["layers"][l], x, st.positions)
        lay = st.lay[(l, j)] = self._layout(l, idx, st.T)
        self.routed[(l, j)] = lay.counts
        buf, meta = zs._pack_at(u2, idx, self.cfg.n_experts, lay.C,
                                lay.offsets)
        st.fwd[(l, j)] = (h, buf, w, idx, meta)
        if self.live[l]:
            for i, hdr in enumerate(self._headers(l, lay)):
                self._post(st, "send", "hdr", l, j, None, self.ranks.M + i,
                           hdr)

    def _send_rows(self, st, l, j, kind, *slot_tensors):
        """Each lane's rows of chunk q, q by q: the rows of every tensor of
        ``slot_tensors`` ([E, C, d]) at this rank's slots of the chunk, in
        one message ([n, d], or [len, n, d] for several)."""
        lay = st.lay[(l, j)]
        flats = [t.view(-1, t.shape[-1]) for t in slot_tensors]
        for q in range(self.Q):
            for i in range(self.ranks.N):
                idx = lay.rows[(q, i)]
                if len(flats) == 1:
                    msg = flats[0].index_select(0, idx)
                else:
                    msg = flats[0].new_empty((len(flats), idx.numel(),
                                              flats[0].shape[-1]))
                    for k, f in enumerate(flats):
                        torch.index_select(f, 0, idx, out=msg[k])
                self._post(st, "send", kind, l, j, q, self.ranks.M + i, msg)

    def _recv_rows(self, st, l, j, kind):
        """Post the receives of every lane's rows of (l, j), chunk by
        chunk, into zeroed [n, d] tensors."""
        lay = st.lay[(l, j)]
        d = self.cfg.d_model
        st.recv[(kind, l, j)] = [
            [self._post(st, "recv", kind, l, j, q, self.ranks.M + i,
                        self._zeros(lay.rows[(q, i)].numel(), d))
             for i in range(self.ranks.N)] for q in range(self.Q)]

    def _d_fwd(self, l, j, st, attn_side, exp_layers):
        if self.live[l]:
            self._send_rows(st, l, j, "F", st.fwd[(l, j)][1])

    def _e_fwd_recv(self, l, j, st, attn_side, exp_layers):
        if self.live[l]:
            self._recv_rows(st, l, j, "Fb")

    def _x_fwd(self, l, j, st, attn_side, exp_layers):
        n_att = self.plan.n_attn_experts(l)
        if n_att:
            buf = st.fwd[(l, j)][1]
            b = st.bloc[(l, j)] = self._local(
                st.lay[(l, j)], buf.view(-1, buf.shape[-1]), n_att)
            st.loc[(l, j)] = self.expert_fwd(attn_side["layers"][l]["ffn"],
                                             b)

    def _h(self, _l, j, st, attn_side, exp_layers):
        l = self.cfg.n_layers - 1
        h, _buf, w, _idx, meta = st.fwd[(l, j)]
        out_full = self._assemble(st, l, j)
        p_head = {k: v for k, v in attn_side.items() if k != "layers"}
        loss, gp, g_comb = self.head_bwd(p_head, h, out_full, w, meta,
                                         st.tgts[j])
        st.losses.append(loss)
        _accumulate(st.ga, gp)
        st.gcomb[(l, j)] = g_comb

    def _c_bwd(self, l, j, st, attn_side, exp_layers):
        if self.live[l]:
            self._send_rows(st, l, j, "B", st.gcomb[(l, j)][1],
                            st.fwd[(l, j)][1])

    def _e_bwd_recv(self, l, j, st, attn_side, exp_layers):
        if self.live[l]:
            self._recv_rows(st, l, j, "Bb")

    def _x_bwd(self, l, j, st, attn_side, exp_layers):
        n_att = self.plan.n_attn_experts(l)
        if n_att:
            d_out = st.gcomb[(l, j)][1]
            g = self._local(st.lay[(l, j)], d_out.view(-1, d_out.shape[-1]),
                            n_att)
            gp, d_loc = self.expert_bwd(attn_side["layers"][l]["ffn"],
                                        st.bloc.pop((l, j)), g)
            _accumulate(st.gl[l], {f"ffn/{k}": v for k, v in gp.items()})
            st.loc[(l, j)] = d_loc

    def _a_bwd(self, l, j, st, attn_side, exp_layers):
        dh, _d_out, dw = st.gcomb.pop((l, j))
        d_buf = self._gather_back(st, l, j, st.fwd.pop((l, j))[1],
                                  st.loc.pop((l, j), None), "Bb")
        gp, dx = self.attn_route_bwd(attn_side["layers"][l],
                                     st.x.pop((l, j)), st.positions, dh,
                                     d_buf, dw, lay=st.lay.pop((l, j)))
        _accumulate(st.gl[l], gp)
        if l > 0:
            h, _buf, w, _idx, meta = st.fwd[(l - 1, j)]
            st.gcomb[(l - 1, j)] = self.combine_bwd(
                h, st.out_full.pop((l - 1, j)), w, meta, dx)
        else:
            gp = self.embed_bwd(attn_side["embed"], st.toks[j], dx)
            _accumulate(st.ga, {f"embed/{k}": g for k, g in gp.items()})

    # Expert lane -------------------------------------------------------

    def _lane_headers(self, l, j, st, attn_side, exp_layers):
        """A(F) on a lane: post the header receives of (l, j) early."""
        if self.live[l]:
            n = 2 * self.lane_experts(l) + self.Q
            st.recv[("hdr", l, j)] = ([
                self._post(st, "recv", "hdr", l, j, None, a,
                           self._zeros(n, dtype=torch.int32))
                for a in range(self.ranks.M)], self._posted())

    def _lane_segments(self, l, hdr, C, Cq) -> dict:
        """{(a, q): the places of attention rank a's rows in chunk q} from
        the ranks' headers, which must tile each expert's kept slots rank
        after rank and give the lane's own row count of every chunk."""
        El, lane = self.lane_experts(l), self.ranks.index
        for e in range(El):
            end = 0
            for a, h in enumerate(hdr):
                s, k = h[e], h[El + e]
                if k < 0 or (k and s != end) or end + k > C:
                    raise RuntimeError(
                        f"lane {lane}, layer {l}: attention rank {a} holds "
                        f"{k} copies of its expert {e} from slot {s}, not "
                        f"from {end}, where the earlier ranks' end, within "
                        f"capacity {C}")
                end += k
        keys, index = [], []
        for a, h in enumerate(hdr):
            for q in range(self.Q):
                rows = chunk_rows(h[:El], h[El:2 * El], q, Cq, Cq, -q * Cq)
                if rows.numel() != h[2 * El + q]:
                    raise RuntimeError(
                        f"lane {lane}, layer {l}: attention rank {a} sends "
                        f"{h[2 * El + q]} rows in chunk {q}, the lane "
                        f"expects {rows.numel()} (capacity {C} in chunks "
                        f"of {Cq})")
                keys.append((a, q))
                index.append(rows)
        on_dev = torch.cat(index).to(self.ranks.device).split(
            [t.numel() for t in index])
        return dict(zip(keys, on_dev))

    def _lane_d_fwd(self, l, j, st, attn_side, exp_layers):
        """D(F) on a lane: read the headers (the lane's one host read a
        (layer, microbatch)) and post the receives of every chunk."""
        if not self.live[l]:
            return
        recvs, posted = st.recv.pop(("hdr", l, j))
        hdr = self._host([w for w, _ in recvs], [t for _, t in recvs],
                         posted)
        C, Cq = self.capacity(st.T)
        seg = st.lay[(l, j)] = self._lane_segments(l, hdr, C, Cq)
        d = self.cfg.d_model
        st.recv[("F", l, j)] = [
            [self._post(st, "recv", "F", l, j, q, a,
                        self._zeros(seg[(a, q)].numel(), d))
             for a in range(self.ranks.M)] for q in range(self.Q)]

    @staticmethod
    def _arrived(parts) -> list:
        """The tensors of posted receives, once each has arrived."""
        for work, _t in parts:
            work.wait()
        return [t for _w, t in parts]

    def _chunk(self, l, rows, seg, q, Cq):
        """A zeroed [E_lane, C_chunk, d] chunk with each attention rank's
        rows of chunk q (``rows[a]``) at their places."""
        buf = self._zeros(self.lane_experts(l) * Cq, self.cfg.d_model)
        for a, t in enumerate(rows):
            buf.index_copy_(0, seg[(a, q)], t)
        return buf.view(-1, Cq, buf.shape[-1])

    def _lane_e_fwd(self, l, j, st, attn_side, exp_layers):
        if not self.live[l]:
            return
        seg, p, Cq = st.lay[(l, j)], exp_layers[l][0], self.capacity(st.T)[1]
        for q, parts in enumerate(st.recv.pop(("F", l, j))):
            o = self.expert_fwd(p, self._chunk(l, self._arrived(parts), seg,
                                               q, Cq))
            o = o.reshape(-1, o.shape[-1])
            for a in range(self.ranks.M):
                self._post(st, "send", "Fb", l, j, q, a,
                           o.index_select(0, seg[(a, q)]))

    def _lane_c_bwd(self, l, j, st, attn_side, exp_layers):
        """C(B) on a lane: post the receives of the cotangent and the
        recompute input, over the forward's segments."""
        if self.live[l]:
            seg, d = st.lay[(l, j)], self.cfg.d_model
            st.recv[("B", l, j)] = [
                [self._post(st, "recv", "B", l, j, q, a,
                            self._zeros(2, seg[(a, q)].numel(), d))
                 for a in range(self.ranks.M)] for q in range(self.Q)]

    def _lane_e_bwd(self, l, j, st, attn_side, exp_layers):
        if not self.live[l]:
            return
        seg, p, Cq = st.lay.pop((l, j)), exp_layers[l][0], \
            self.capacity(st.T)[1]
        for q, parts in enumerate(st.recv.pop(("B", l, j))):
            msgs = self._arrived(parts)
            g = self._chunk(l, [m[0] for m in msgs], seg, q, Cq)
            b = self._chunk(l, [m[1] for m in msgs], seg, q, Cq)
            gp, d_b = self.expert_bwd(p, b, g)
            _accumulate(st.ge[l], gp)
            d_b = d_b.reshape(-1, d_b.shape[-1])
            for a in range(self.ranks.M):
                self._post(st, "send", "Bb", l, j, q, a,
                           d_b.index_select(0, seg[(a, q)]))

    _ATTN = {("A", "F"): _a_fwd, ("D", "F"): _d_fwd, ("E", "F"): _e_fwd_recv,
             ("X", "F"): _x_fwd, ("H", "F"): _h, ("C", "B"): _c_bwd,
             ("E", "B"): _e_bwd_recv, ("X", "B"): _x_bwd,
             ("A", "B"): _a_bwd}
    _LANE = {("A", "F"): _lane_headers, ("D", "F"): _lane_d_fwd,
             ("E", "F"): _lane_e_fwd, ("C", "B"): _lane_c_bwd,
             ("E", "B"): _lane_e_bwd}


@dataclasses.dataclass
class _RankStep:
    """What one rank holds between its tasks, by (layer, microbatch); each
    entry is popped by its last reader."""
    T: int                     # tokens a microbatch, over every rank
    cursor: Dict               # messages posted with each peer
    toks: torch.Tensor = None  # this rank's rows (attention ranks)
    tgts: torch.Tensor = None
    positions: torch.Tensor = None
    lay: Dict = dataclasses.field(default_factory=dict)   # layouts
    recv: Dict = dataclasses.field(default_factory=dict)  # posted receives
    pending: list = dataclasses.field(default_factory=list)  # sends
    hop_bytes: Dict = dataclasses.field(default_factory=dict)
    traffic: Dict = dataclasses.field(default_factory=dict)
    x: Dict = dataclasses.field(default_factory=dict)
    fwd: Dict = dataclasses.field(default_factory=dict)
    bloc: Dict = dataclasses.field(default_factory=dict)  # X inputs
    loc: Dict = dataclasses.field(default_factory=dict)   # X outputs
    out_full: Dict = dataclasses.field(default_factory=dict)
    gcomb: Dict = dataclasses.field(default_factory=dict)
    losses: list = dataclasses.field(default_factory=list)
    ga: Dict = dataclasses.field(default_factory=dict)
    gl: Dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(dict))
    ge: Dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(dict))
