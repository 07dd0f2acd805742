"""Zebra parallelism, the MPMD engine (mirror of
``repro/core/zebra_mpmd.py``): the paper-faithful disaggregation.

Two groups run two different programs, as HeterMoE deploys on
mixed-generation clusters:

    attention group: embeddings, attention blocks, routers, combines,
        head and loss, and the Asym-EA-offloaded experts;
    expert group (N lanes): expert FFNs only, the remote experts split
        evenly over the lanes (the reference shards them over its expert
        mesh, ``P("expert")``).

Activations cross the groups as capacity-packed [E, C, d] buffers; with
``n_chunks`` Q > 1 each hop carries Q capacity chunks, so a lane runs
chunk q while chunk q+1 is on its way, forward and backward.

The host issues Theorem 1's tasks (``schedule.canonical_schedule``): its
four per-stream lists are merged into one issue order by
:func:`issue_order`, each list's order kept. Each task runs the
reference's stage programs:

    A(F,l,j)  combine(l-1, j) (l = 0: embed), then attn_route(l, j)
    D(F,l,j)  the hop of each capacity chunk of the remote buffer to its
              lane
    E(F,l,j)  expert_fwd on every lane, chunk by chunk
    X(F,l,j)  local_expert_fwd (the offloaded experts)
    C(F,l,j)  the hop of the lanes' chunk outputs back
    H(j)      assemble + combine(L-1, j), head_loss, the head's backward
              and combine_bwd(L-1, j)
    C(B,l,j)  the hop of each chunk's cotangent and recompute input
    E(B,l,j)  expert_bwd on every lane, chunk by chunk
    X(B,l,j)  local_expert_bwd
    D(B,l,j)  the hop of the lanes' input gradients back
    A(B,l,j)  attn_route_bwd(l, j), then combine_bwd(l-1, j) (l = 0: the
              embedding's backward)

The reference's own loop issues combine(l, j) right after the experts of
(l, j), before attn_route(l, j+1), and every head after the whole
forward; on a device whose queues run in order, that holds the attention
of microbatch j+1 behind the experts of microbatch j. Here the combine is
part of the next layer's A task, and the last layer interleaves forward
and backward per microbatch, as Theorem 1 orders them. Every stage
program and every result is the reference's.

On CUDA the attention group runs on the caller's stream and each lane on
a stream of its own. A hop between two streams of one device is a
hand-off, with no copy (``jax.device_put`` to the same device is none
either): the consumer's stream waits on the producer's event and marks
the tensors with ``record_stream``, so the caching allocator does not
reuse their memory while the consumer may still read it. The waits are
placed where a task reads its inputs, so a stream never waits on work it
does not need. On the CPU the same walker runs with no streams.

This engine drives one device: lanes on another device than the
attention group and a microbatch split over several attention devices
run in rank mode (``core/zebra_mpmd_ranks.py``, one process a rank), and
the engine raises for both. The attention group's size M still enters
the planner.

With ``obs.trace.TRACER`` enabled, a step emits the reference's spans on
the ``zebra-mpmd`` track (pid ``train``): ``embed mb{j}``, ``F l{l}
mb{j}``, ``head mb{j}``, ``B l{l} mb{j}``, ``embed^B mb{j}``, with the
reference's args. The issue order interleaves the (layer, microbatch)
units, so their spans overlap and would mis-nest on the tracer's begin /
end stack: each is a complete span (``span_at``) over the positions of
its tasks in the issue order, from its first task to the one that
completes it (its combine: the next layer's A task or the head), one
microsecond a task from the step's tick. Tracing reads no tensor, so a
traced step computes what an untraced one does, bit for bit.

Backward uses stage-granular recompute (the paper's §6.1 setting): each
stage's backward re-runs its forward under ``torch.enable_grad`` and
calls ``torch.autograd.grad`` with the given cotangents. The gate-score
branch is handled as the reference handles it: the cotangent of the
attention output h arrives from both paths, the dispatched tokens (the
packed buffers) and the combine weights, before the attention stage's
backward runs. The loss is the plain log-softmax NLL, with no aux or z
loss, as the reference's.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional

import torch

from repro_torch.core import schedule as S
from repro_torch.core import zebra_spmd as zs
from repro_torch.kernels import ops as kops
from repro_torch.models import modules
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import RunConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.pytree import flatten, tree_map

EXPERT_KEYS = ("wi_gate", "wi_up", "wo")
TRACK = "zebra-mpmd"


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class MPMDPlan:
    """Expert placement: per layer, how many experts live on the attention
    group (= offload[l] * N, Asym-EA §4.2). Experts [0, n_att) -> attention
    group; [n_att, E) -> expert group."""

    n_experts: int
    offload: tuple  # per-layer experts offloaded per expert device
    N: int

    def n_attn_experts(self, layer: int) -> int:
        return self.offload[layer] * self.N


def issue_order(sched: S.ZebraSchedule) -> List[S.Task]:
    """One host issue order of the schedule's per-stream lists: each
    list's order is kept; the streams are visited in turn, and each visit
    issues the stream's next task if every one of its dependencies has
    been issued."""
    queues = list(sched.streams.values())
    heads = [0] * len(queues)
    issued, order = set(), []
    total = sum(len(q) for q in queues)
    while len(order) < total:
        progressed = False
        for i, q in enumerate(queues):
            if heads[i] == len(q):
                continue
            task = q[heads[i]]
            if all(d in issued for d in
                   S.dependencies(task, sched.L, sched.offload)):
                order.append(task)
                issued.add(task)
                heads[i] += 1
                progressed = True
        if not progressed:
            stuck = [q[h] for q, h in zip(queues, heads) if h < len(q)]
            raise ValueError(f"schedule deadlocks at {stuck}")
    return order


def trace_spans(order: List[S.Task], L: int, Q: int) -> Dict[int, list]:
    """The reference's spans (``repro/core/zebra_mpmd.py:282-383``) over
    an issue order: {index of the task that closes a span: [(name, index
    of its first task, args)]}. A forward unit (l, j) runs from its first
    task to its combine (A(F, l+1, j), or the head at the last layer), a
    backward unit from its first task to A(B, l, j); the embedding, the
    head and the embedding's backward are one task each."""
    at = {t: i for i, t in enumerate(order)}
    first: Dict[tuple, int] = {}
    for i, (kind, phase, l, j) in enumerate(order):
        if kind != "H":
            first.setdefault((phase, l, j), i)
    head = {t[3]: i for i, t in enumerate(order) if t[0] == "H"}
    spans = []
    for j in sorted(head):
        a0, b0 = at[("A", "F", 0, j)], at[("A", "B", 0, j)]
        spans.append((f"embed mb{j}", a0, a0, {"microbatch": j}))
        for l in range(L):
            end = at[("A", "F", l + 1, j)] if l + 1 < L else head[j]
            spans.append((f"F l{l} mb{j}", first[("F", l, j)], end,
                          {"layer": l, "microbatch": j, "chunks": Q}))
        spans.append((f"head mb{j}", head[j], head[j], {"microbatch": j}))
        for l in range(L):
            spans.append((f"B l{l} mb{j}", first[("B", l, j)],
                          at[("A", "B", l, j)],
                          {"layer": l, "microbatch": j, "chunks": Q}))
        spans.append((f"embed^B mb{j}", b0, b0, {"microbatch": j}))
    closing: Dict[int, list] = collections.defaultdict(list)
    for name, i0, i1, args in sorted(spans, key=lambda s: (s[2], s[1])):
        closing[i1].append((name, i0, args))
    return dict(closing)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _cat(ts, dim: int):
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim)


def _leaves(tree) -> dict:
    """{path: leaf} of ``tree``, each leaf a fresh autograd leaf (detached
    from the caller's tensor, sharing its memory)."""
    return {k: v.detach().requires_grad_()
            for k, v in flatten(tree).items()}


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _accumulate(acc: dict, grads: dict) -> None:
    for k, g in grads.items():
        if g is not None:
            acc[k] = g if k not in acc else acc[k] + g


class _Handoff(NamedTuple):
    """Tensors made on one stream for another: the event the consumer
    waits on (None: no streams, or the same stream)."""
    tensors: tuple
    event: Optional[torch.cuda.Event]


def _take(stream, ho: _Handoff) -> tuple:
    """The hand-off's tensors, readable on ``stream``."""
    if ho.event is not None:
        stream.wait_event(ho.event)
        for t in ho.tensors:
            t.record_stream(stream)
    return ho.tensors


class ZebraMPMD:
    """Disaggregated MoE training over two device groups."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, attn_devices,
                 exp_devices, num_microbatches: int = 2,
                 offload: Optional[tuple] = None,
                 capacity_factor: Optional[float] = None,
                 n_chunks: int = 1, *, streams: bool = True):
        assert cfg.is_moe, "MPMD zebra engine is for MoE architectures"
        assert not cfg.tail_specs, "use pattern-aligned layer counts"
        self.cfg = cfg
        self.run = run
        self.R = num_microbatches
        self.Q = max(int(n_chunks), 1)
        self.M = len(attn_devices)
        self.N = len(exp_devices)
        attn = {_device(d) for d in attn_devices}
        if len(attn) != 1:
            raise NotImplementedError(
                f"attention devices {sorted(map(str, attn))}: one process "
                f"drives one device; a microbatch split over several "
                f"attention devices runs in rank mode, one process a rank "
                f"(zebra_mpmd_ranks.ZebraMPMDRanks, hetero_mpmd --ranks)")
        (self.attn_device,) = attn
        self.exp_devices = [_device(d) for d in exp_devices]
        if any(d != self.attn_device for d in self.exp_devices):
            raise NotImplementedError(
                f"expert lanes on {[str(d) for d in self.exp_devices]} "
                f"beside attention on {self.attn_device}: one process "
                f"drives one device; lanes on other devices run in rank "
                f"mode, one process a rank (zebra_mpmd_ranks.ZebraMPMDRanks,"
                f" hetero_mpmd --ranks)")
        offload = tuple(offload) if offload else tuple([0] * cfg.n_layers)
        self.plan = MPMDPlan(cfg.n_experts, offload, self.N)
        E = cfg.n_experts
        for l in range(cfg.n_layers):
            n_att = self.plan.n_attn_experts(l)
            if not 0 <= n_att <= E or (E - n_att) % self.N:
                raise ValueError(
                    f"layer {l}: {n_att} offloaded experts leave {E - n_att}"
                    f" remote experts, which do not split over "
                    f"{self.N} expert lanes")
        self.cf = capacity_factor or cfg.capacity_factor
        self.spec = cfg.pattern[0]
        self.cd = run.policy.compute_dtype
        self.streams = streams
        self.schedule = S.canonical_schedule(cfg.n_layers, self.R, offload,
                                             self.Q)
        self.order = issue_order(self.schedule)  # what train_step walks
        self.spans = trace_spans(self.order, cfg.n_layers, self.Q)
        self._lane_streams = None

    def lane_experts(self, layer: int) -> int:
        """Experts per expert lane at ``layer``."""
        return (self.cfg.n_experts - self.plan.n_attn_experts(layer)) \
            // self.N

    def capacity(self, T: int) -> tuple:
        """(C, C_chunk) of a microbatch of T tokens: C0 = max(round_up(
        int(T k / E cf), 8), 8), padded to Q chunks of a multiple of 8
        rows (``ops.chunk_capacity``)."""
        cfg = self.cfg
        C0 = max(_round_up(int(T * cfg.top_k / cfg.n_experts * self.cf), 8),
                 8)
        return kops.chunk_capacity(C0, self.Q)

    # ------------------------------------------------------------------
    # Parameter placement
    # ------------------------------------------------------------------

    def shard_params(self, params):
        """Split a fused param tree into (attn_side, exp_layers).
        attn_side: embed, final_norm (lm_head) and per layer its attention
        block, router and offloaded experts [0, n_att), on the attention
        device; exp_layers[l]: a list of N lane dicts, lane i holding
        experts [n_att + i E_lane, n_att + (i+1) E_lane) on its device."""
        dev = self.attn_device
        blocks = params["blocks"]["pos0"]
        attn_side = {k: tree_map(lambda t: t.to(dev), params[k])
                     for k in ("embed", "final_norm", "lm_head")
                     if k in params}
        attn_layers, exp_layers = [], []
        for l in range(self.cfg.n_layers):
            lp = tree_map(lambda x: x[l], blocks)
            n_att = self.plan.n_attn_experts(l)
            ffn = lp.pop("ffn")
            lp["ffn"] = {"router": ffn["router"],
                         **{k: ffn[k][:n_att] for k in EXPERT_KEYS}}
            attn_layers.append(tree_map(lambda t: t.to(dev), lp))
            El = self.lane_experts(l)
            exp_layers.append([
                {k: ffn[k][n_att + i * El:n_att + (i + 1) * El].to(d)
                 for k in EXPERT_KEYS}
                for i, d in enumerate(self.exp_devices)])
        attn_side["layers"] = attn_layers
        return attn_side, exp_layers

    # ------------------------------------------------------------------
    # Stage programs
    # ------------------------------------------------------------------

    def embed(self, p_embed, tokens):
        return modules.apply_embedding(p_embed, self.cfg, self.run.policy,
                                       tokens)

    def attn_route(self, p_layer, x, positions):
        """Attention block + router + dispatch packing (attention group).
        Returns (h, buf [E, C, d], weights, idx, meta); the remote buffer
        is buf[n_att:], the local one buf[:n_att]."""
        cfg, run = self.cfg, self.run
        h, _ = modules.apply_mixer_part(p_layer, cfg, run, self.spec, x,
                                        positions)
        u = modules.apply_norm(p_layer["norm2"], h, run.policy)
        u2 = u.reshape(-1, u.shape[-1])
        weights, idx, _aux = modules.moe_route(p_layer["ffn"]["router"], cfg,
                                               run.policy, u2)
        C, _ = self.capacity(u2.shape[0])
        buf, meta = zs._pack(u2, idx, cfg.n_experts, C)
        return h, buf, weights, idx, meta

    def expert_fwd(self, p_exp, buf):
        """Grouped FFN straight over a capacity-packed [E_loc, C, d] buffer
        (the packed domain: no re-sort, no re-pack). An empty buffer (no
        experts here) is returned as it is: it never reaches a kernel."""
        if buf.shape[0] == 0:
            return buf
        return zs._experts_dense(p_exp["wi_gate"], p_exp["wi_up"],
                                 p_exp["wo"], buf, self.cd)

    @staticmethod
    def assemble(out_local, out_chunks):
        """Stitch the local output and the remote chunk outputs (each
        [E_rem, C_chunk, d]) into ONE packed [E, C, d] buffer."""
        rem = _cat(out_chunks, 1)
        return torch.cat([out_local.to(rem.dtype), rem], 0)

    @staticmethod
    def combine(h, out, weights, meta):
        """Weighted combine over ONE packed [E, C, d] expert output."""
        B, S_, d = h.shape
        y2 = zs._unpack(out, meta, weights, B * S_)
        return h + y2.reshape(h.shape).to(h.dtype)

    def head_loss(self, p, x, targets):
        policy = self.run.policy
        xn = modules.apply_norm(p["final_norm"], x, policy)
        logits = modules.apply_unembedding(p["embed"], p.get("lm_head"),
                                           self.cfg, policy, xn)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
        return nll.mean()

    # Backward (stage recompute) ----------------------------------------

    def head_bwd(self, p_head, h, out, weights, meta, targets):
        """combine(L-1) + head_loss and their backward: (loss, grads of
        p_head by path, (dh, d_out, d_weights))."""
        with torch.enable_grad():
            ps = _leaves(p_head)
            hh, oo, ww = (t.detach().requires_grad_()
                          for t in (h, out, weights))
            x = self.combine(hh, oo, ww, meta)
            loss = self.head_loss(_unflatten(ps), x, targets)
            grads = torch.autograd.grad(loss, [*ps.values(), hh, oo, ww],
                                        allow_unused=True)
        n = len(ps)
        return loss.detach(), dict(zip(ps, grads[:n])), grads[n:]

    def combine_bwd(self, h, out, weights, meta, g):
        with torch.enable_grad():
            hh, oo, ww = (t.detach().requires_grad_()
                          for t in (h, out, weights))
            y = self.combine(hh, oo, ww, meta)
            return torch.autograd.grad(y, (hh, oo, ww), g)

    def expert_bwd(self, p_exp, buf, g):
        """(grads of the lane's experts, d_buf)."""
        if buf.shape[0] == 0:
            return {k: torch.zeros_like(p_exp[k]) for k in EXPERT_KEYS}, g
        with torch.enable_grad():
            ws = {k: p_exp[k].detach().requires_grad_() for k in EXPERT_KEYS}
            b = buf.detach().requires_grad_()
            out = self.expert_fwd(ws, b)
            grads = torch.autograd.grad(out, [*ws.values(), b], g)
        return dict(zip(ws, grads[:-1])), grads[-1]

    def attn_route_bwd(self, p_layer, x, positions, g_h, g_buf, g_weights,
                       **route):
        """Backward of attn_route: (grads of the attention block and router
        by path, dx). The cotangent of h arrives already
        accumulated from both branches: the dispatched tokens (g_buf, the
        local and remote parts) and the gate path (g_weights). ``route``
        goes to the recomputed ``attn_route``."""
        p = {k: v for k, v in p_layer.items() if k != "ffn"}
        p["ffn"] = {"router": p_layer["ffn"]["router"]}
        with torch.enable_grad():
            ps = _leaves(p)
            xx = x.detach().requires_grad_()
            h, buf, w, _idx, _meta = self.attn_route(_unflatten(ps), xx,
                                                     positions, **route)
            grads = torch.autograd.grad((h, buf, w), [*ps.values(), xx],
                                        (g_h, g_buf, g_weights))
        return dict(zip(ps, grads[:-1])), grads[-1]

    def embed_bwd(self, p_embed, tokens, g):
        with torch.enable_grad():
            ps = _leaves(p_embed)
            x = self.embed(_unflatten(ps), tokens)
            grads = torch.autograd.grad(x, list(ps.values()), g)
        return dict(zip(ps, grads))

    # ------------------------------------------------------------------
    # Streams
    # ------------------------------------------------------------------

    def _open_streams(self):
        """(attention stream, lane streams): the caller's stream and one
        stream per lane, made once; Nones on the CPU or with
        ``streams=False``."""
        if not (self.streams and self.attn_device.type == "cuda"):
            return None, [None] * self.N
        if self._lane_streams is None:
            self._lane_streams = [torch.cuda.Stream(d)
                                  for d in self.exp_devices]
        return (torch.cuda.current_stream(self.attn_device),
                self._lane_streams)

    @staticmethod
    def _on(stream):
        return torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()

    @staticmethod
    def _event(stream):
        return stream.record_event() if stream is not None else None

    # ------------------------------------------------------------------
    # One training iteration in Theorem 1's issue order
    # ------------------------------------------------------------------

    def train_step(self, attn_side, exp_layers, tokens, targets):
        """One full training iteration: (loss, grads_attn, grads_exp), the
        gradients shaped as ``attn_side`` and ``exp_layers`` and on their
        devices. Gradients are summed over the microbatches in ascending
        order, then scaled by 1/R."""
        R, L = self.R, self.cfg.n_layers
        dev = self.attn_device
        tokens, targets = tokens.to(dev), targets.to(dev)
        B = tokens.shape[0]
        assert B % R == 0
        attn, lanes = self._open_streams()
        st = _Step(toks=tokens.reshape(R, B // R, -1),
                   tgts=targets.reshape(R, B // R, -1), attn=attn,
                   lanes=lanes, ge=[[{} for _ in range(self.N)]
                                    for _ in range(L)])
        S_ = st.toks.shape[-1]
        st.positions = torch.arange(S_, dtype=torch.int32,
                                    device=dev).expand(B // R, S_)
        if attn is not None:  # the lanes start after the caller's work
            for i, lane in enumerate(lanes):
                lane.wait_stream(attn)
                for p in exp_layers:
                    for t in p[i].values():
                        t.record_stream(lane)
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.declare_track(TRACK, pid="train")
            base = tr.now * obs_trace.TICK_US  # one microsecond a task
        with torch.no_grad():  # the backward stages re-enable it
            for i, task in enumerate(self.order):
                self._TASKS[task[:2]](self, task[2], task[3], st, attn_side,
                                      exp_layers)
                if tr.enabled:
                    for name, i0, args in self.spans.get(i, ()):
                        tr.span_at(TRACK, name, (base + i0) / 1e6,
                                   (base + i + 1) / 1e6, **args)
            return self._finish(st, attn_side, exp_layers)

    def _finish(self, st, attn_side, exp_layers):
        attn, lanes = st.attn, st.lanes
        if attn is not None:  # the lanes' gradients join the caller
            for lane in lanes:
                attn.wait_stream(lane)
            for per_lane in st.ge:
                for acc in per_lane:
                    for t in acc.values():
                        t.record_stream(attn)
        scale = 1.0 / self.R

        def scaled(acc, k, like):  # the sums are the engine's own tensors
            return acc[k].mul_(scale) if k in acc else torch.zeros_like(like)
        loss = sum(st.losses) / self.R
        flat = flatten({k: v for k, v in attn_side.items() if k != "layers"})
        grads_a = _unflatten({k: scaled(st.ga, k, v)
                              for k, v in flat.items()})
        grads_a["layers"] = [
            _unflatten({k: scaled(st.gl[l], k, v)
                        for k, v in flatten(layer).items()})
            for l, layer in enumerate(attn_side["layers"])]
        grads_e = [[{k: scaled(acc, k, lane[k]) for k in EXPERT_KEYS}
                    for acc, lane in zip(st.ge[l], exp_layers[l])]
                   for l in range(self.cfg.n_layers)]
        return loss, grads_a, grads_e

    # Tasks -------------------------------------------------------------

    def _arrived(self, st, l, j):
        """The lanes' outputs of (l, j) handed back (C(F) or D(B)), taken
        on the attention stream: one [E_rem, C_chunk, d] tensor a chunk."""
        return [_cat([_take(st.attn, ho)[0] for ho in per_lane], 0)
                for per_lane in st.outs.pop((l, j))]

    def _assemble(self, st, l, j):
        """assemble(l, j) on the attention stream: the local output (the
        empty local buffer itself without offloaded experts) and the
        lanes' chunk outputs."""
        n_att = self.plan.n_attn_experts(l)
        return self.assemble(st.loc.pop((l, j), st.fwd[(l, j)][1][:n_att]),
                             self._arrived(st, l, j))

    def _a_fwd(self, l, j, st, attn_side, exp_layers):
        if l == 0:
            x = self.embed(attn_side["embed"], st.toks[j])
        else:
            h, _buf, w, _idx, meta = st.fwd[(l - 1, j)]
            out_full = st.out_full[(l - 1, j)] = self._assemble(st, l - 1, j)
            x = self.combine(h, out_full, w, meta)
        st.x[(l, j)] = x
        st.fwd[(l, j)] = self.attn_route(attn_side["layers"][l], x,
                                         st.positions)
        st.ev[(l, j)] = self._event(st.attn)

    def _chunks(self, t, l):
        """[[lane i's slice of chunk q] for i] for q] of a remote buffer."""
        El, Cq = self.lane_experts(l), t.shape[1] // self.Q
        return [[t[i * El:(i + 1) * El, q * Cq:(q + 1) * Cq]
                 for i in range(self.N)] for q in range(self.Q)]

    def _d_fwd(self, l, j, st, attn_side, exp_layers):
        n_att = self.plan.n_attn_experts(l)
        ev = st.ev.pop((l, j))
        st.sent[(l, j)] = [[_Handoff((b,), ev) for b in per_lane]
                           for per_lane in self._chunks(
                               st.fwd[(l, j)][1][n_att:], l)]

    def _e_fwd(self, l, j, st, attn_side, exp_layers):
        outs = []
        for per_lane in st.sent.pop((l, j)):
            row = []
            for i, ho in enumerate(per_lane):
                lane = st.lanes[i]
                with self._on(lane):
                    (b,) = _take(lane, ho)
                    o = self.expert_fwd(exp_layers[l][i], b)
                    row.append((o, self._event(lane)))
            outs.append(row)
        st.e_out[(l, j)] = outs

    def _x_fwd(self, l, j, st, attn_side, exp_layers):
        n_att = self.plan.n_attn_experts(l)
        f = attn_side["layers"][l]["ffn"]
        st.loc[(l, j)] = self.expert_fwd(f, st.fwd[(l, j)][1][:n_att])

    def _hop_back(self, l, j, st, attn_side, exp_layers):
        """C(F) / D(B): the lanes' outputs handed to the attention group."""
        st.outs[(l, j)] = [[_Handoff((o,), ev) for o, ev in row]
                           for row in st.e_out.pop((l, j))]

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
        st.ev[(l, j)] = self._event(st.attn)

    def _c_bwd(self, l, j, st, attn_side, exp_layers):
        n_att = self.plan.n_attn_experts(l)
        d_out = st.gcomb[(l, j)][1]
        ev = st.ev.pop((l, j))
        gs = self._chunks(d_out[n_att:], l)
        bs = self._chunks(st.fwd[(l, j)][1][n_att:], l)
        st.sent[(l, j)] = [[_Handoff((g, b), ev) for g, b in zip(gq, bq)]
                           for gq, bq in zip(gs, bs)]

    def _e_bwd(self, l, j, st, attn_side, exp_layers):
        outs = []
        for per_lane in st.sent.pop((l, j)):
            row = []
            for i, ho in enumerate(per_lane):
                lane = st.lanes[i]
                with self._on(lane):
                    g, b = _take(lane, ho)
                    gp, d_b = self.expert_bwd(exp_layers[l][i], b, g)
                    _accumulate(st.ge[l][i], gp)
                    row.append((d_b, self._event(lane)))
            outs.append(row)
        st.e_out[(l, j)] = outs

    def _x_bwd(self, l, j, st, attn_side, exp_layers):
        n_att = self.plan.n_attn_experts(l)
        f = attn_side["layers"][l]["ffn"]
        gp, d_buf_l = self.expert_bwd(f, st.fwd[(l, j)][1][:n_att],
                                      st.gcomb[(l, j)][1][:n_att])
        _accumulate(st.gl[l], {f"ffn/{k}": g for k, g in gp.items()})
        st.loc[(l, j)] = d_buf_l

    def _a_bwd(self, l, j, st, attn_side, exp_layers):
        n_att = self.plan.n_attn_experts(l)
        dh, d_out, dw = st.gcomb.pop((l, j))
        d_buf = torch.cat([st.loc.pop((l, j), d_out[:n_att]),
                           _cat(self._arrived(st, l, j), 1)], 0)
        st.fwd.pop((l, j))
        gp, dx = self.attn_route_bwd(attn_side["layers"][l],
                                     st.x.pop((l, j)), st.positions, dh,
                                     d_buf, dw)
        _accumulate(st.gl[l], gp)
        if l > 0:
            h, _buf, w, _idx, meta = st.fwd[(l - 1, j)]
            st.gcomb[(l - 1, j)] = self.combine_bwd(
                h, st.out_full.pop((l - 1, j)), w, meta, dx)
            st.ev[(l - 1, j)] = self._event(st.attn)
        else:
            gp = self.embed_bwd(attn_side["embed"], st.toks[j], dx)
            _accumulate(st.ga, {f"embed/{k}": g for k, g in gp.items()})

    _TASKS = {("A", "F"): _a_fwd, ("D", "F"): _d_fwd, ("E", "F"): _e_fwd,
              ("X", "F"): _x_fwd, ("C", "F"): _hop_back, ("H", "F"): _h,
              ("C", "B"): _c_bwd, ("E", "B"): _e_bwd, ("X", "B"): _x_bwd,
              ("D", "B"): _hop_back, ("A", "B"): _a_bwd}


@dataclasses.dataclass
class _Step:
    """What one training iteration holds between its tasks, by (layer,
    microbatch); each entry is popped by its last reader."""
    toks: torch.Tensor
    tgts: torch.Tensor
    attn: Optional[torch.cuda.Stream]
    lanes: list
    ge: list                   # [layer][lane] {key: grad}
    positions: torch.Tensor = None
    x: Dict = dataclasses.field(default_factory=dict)      # layer inputs
    fwd: Dict = dataclasses.field(default_factory=dict)    # attn_route out
    ev: Dict = dataclasses.field(default_factory=dict)     # for the hops
    sent: Dict = dataclasses.field(default_factory=dict)   # hops to lanes
    e_out: Dict = dataclasses.field(default_factory=dict)  # lane outputs
    outs: Dict = dataclasses.field(default_factory=dict)   # hops back
    loc: Dict = dataclasses.field(default_factory=dict)    # X outputs
    out_full: Dict = dataclasses.field(default_factory=dict)
    gcomb: Dict = dataclasses.field(default_factory=dict)  # (dh, dout, dw)
    losses: list = dataclasses.field(default_factory=list)
    ga: Dict = dataclasses.field(default_factory=dict)     # embed, head
    gl: Dict = dataclasses.field(                          # per layer
        default_factory=lambda: collections.defaultdict(dict))
