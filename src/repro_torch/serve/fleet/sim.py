"""Fleet-level trace replay: N prefill + M decode groups, elastic flips,
group kills (DESIGN.md §12; a copy of the JAX package's
``serve/fleet/sim.py`` with its import rewritten to the port).

The per-group model matches ``core.simulator.simulate_serve_trace``: a
prefill group is a sequential batch-1 stream (a request occupies it for
``ceil(len/chunk) * t_prefill_chunk``), a decode group steps all of its
active slots every ``t_decode_step``, and a finished prefill becomes a
ticket that is admissible ``t_handoff`` later. On top of that, this
simulator adds the three fleet mechanisms the real ``FleetController``
implements:

* **routing** — arrivals go to the prefill group with the least backlog
  per unit speed; tickets admit strictly FIFO (head-of-line, like the
  real controller's pending deque) to the decode group with the lowest
  occupancy-per-speed among those with a free slot;
* **elastic role flips** — every ``control_dt`` the policy may flip ONE
  idle group to the overloaded role (decode backlog → prefill group
  becomes a decode group, and back), paying ``flip_delay`` of
  unavailability; a flip never removes the last group of a role;
* **failure** — at each ``kills`` time a group vanishes; its in-flight
  requests re-enter the router ``detect_delay`` later (the heartbeat
  grace window) and RE-PREFILL their prompt plus every token already
  emitted, so recovery is priced as real token-exact replay. Emitted
  tokens are never un-emitted: the recovery gap lands in the request's
  max inter-token latency, which is exactly where an SLO feels it.

A request is **good** iff its TTFT ≤ ``slo_ttft`` and its worst ITL ≤
``slo_itl``; goodput-under-SLO counts only good requests' tokens. With
``slo_admission`` on, an ARRIVAL whose best achievable prefill ETA
already exceeds ``slo_ttft`` is SHED at the door (DESIGN.md §13) — an
explicit outcome instead of a guaranteed-late finish; recovery
re-entries are never shed (their tokens are already paid for). Pure
python, deterministic, host-only.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.metrics import percentile

_INF = float("inf")


@dataclasses.dataclass
class SimGroup:
    """One serving group as the fleet simulator sees it. Carries BOTH
    role clocks so an elastic flip is just ``role = other``."""

    gid: int
    cls: str                  # device-class name (display only)
    role: str                 # 'prefill' | 'decode'
    t_prefill_chunk: float
    t_decode_step: float
    decode_slots: int
    # -- runtime state (owned by the simulator) --
    alive: bool = True
    avail_at: float = 0.0     # role-flip latency: unusable before this
    queue: deque = dataclasses.field(default_factory=deque)   # prefill idx
    queued_chunks: int = 0    # incremental sum of chunks over `queue`
    current: Optional[int] = None                             # prefilling idx
    busy_until: float = _INF
    active: Dict[int, int] = dataclasses.field(default_factory=dict)
    next_tick: float = _INF
    draining: bool = False    # decode→prefill flip staged: admit() skips it
    flips: int = 0

    def idle(self) -> bool:
        if self.role == "prefill":
            return self.current is None and not self.queue
        return not self.active


@dataclasses.dataclass(frozen=True)
class FleetSimResult:
    makespan: float
    goodput: float            # finished tokens / makespan
    goodput_under_slo: float  # tokens of SLO-good finished reqs / makespan
    ttft_p99: float
    itl_p99: float            # p99 of per-request WORST inter-token gap
    n_requests: int
    n_finished: int
    n_good: int
    n_flips: int
    n_shed: int = 0           # SLO-infeasible arrivals shed at admission


@dataclasses.dataclass
class _Req:
    arrival: float
    prompt: int
    gen: int
    generated: int = 0
    ttft: Optional[float] = None
    last_tok: Optional[float] = None
    max_itl: float = 0.0
    done_at: Optional[float] = None

    def emit(self, t: float) -> None:
        if self.ttft is None:
            self.ttft = t - self.arrival
        elif self.last_tok is not None:
            self.max_itl = max(self.max_itl, t - self.last_tok)
        self.last_tok = t
        self.generated += 1
        if self.generated >= self.gen:
            self.done_at = t

    def replay_len(self, prefill_chunk: int) -> int:
        """Token-exact recovery re-prefills prompt + emitted tokens."""
        return -(-(self.prompt + self.generated) // prefill_chunk)


def simulate_fleet_trace(reqs, groups: Sequence[SimGroup], *,
                         prefill_chunk: int, t_handoff: float = 0.0,
                         elastic: bool = False, control_dt: float = 1.0,
                         flip_delay: float = 0.5,
                         wait_hi: float = 0.25, backlog_s_hi: float = 1.0,
                         kills: Sequence[Tuple[float, int]] = (),
                         detect_delay: float = 1.0,
                         slo_ttft: float = _INF, slo_itl: float = _INF,
                         slo_admission: bool = False,
                         max_events: int = 10_000_000) -> FleetSimResult:
    """Replay ``reqs`` (ServeRequest list) through a group fleet.

    ``groups`` are mutated (role, queues); pass fresh ones per run.
    ``kills`` is [(time, gid)]: the group dies at that time, its work
    re-enters the router ``detect_delay`` later. ``slo_admission``
    sheds arrivals whose best prefill ETA exceeds ``slo_ttft``.
    """
    groups = list(groups)
    by_gid = {g.gid: g for g in groups}
    if len(by_gid) != len(groups):
        raise ValueError("duplicate gid")
    R = [_Req(r.arrival, r.prompt, r.gen) for r in reqs]
    arrivals = sorted(range(len(R)), key=lambda i: (R[i].arrival, i))
    a_ptr = 0
    kill_list = sorted(kills)
    k_ptr = 0
    pending: deque = deque()           # (ready_time, idx) FIFO tickets
    delayed: List[Tuple[float, int]] = []  # recovery re-entries
    t = 0.0
    next_ctrl = control_dt if elastic else _INF
    n_flips = 0
    n_shed = 0

    def prefill_groups():
        return [g for g in groups if g.alive and g.role == "prefill"]

    def decode_groups():
        return [g for g in groups if g.alive and g.role == "decode"]

    def chunks_of(i: int) -> int:
        return R[i].replay_len(prefill_chunk)

    def backlog_s(g: SimGroup) -> float:
        n = g.queued_chunks
        if g.current is not None:
            n += 1  # at least the tail of the in-flight request
        return n * g.t_prefill_chunk

    def route_prefill(i: int, now: float) -> None:
        cands = [g for g in prefill_groups() if g.avail_at <= now]
        cands = cands or prefill_groups()
        if not cands:
            return  # no prefill capacity left; request is stranded
        g = min(cands, key=lambda g: (backlog_s(g)
                                      + chunks_of(i) * g.t_prefill_chunk,
                                      g.gid))
        g.queue.append(i)
        g.queued_chunks += chunks_of(i)
        start_prefill(g, max(now, g.avail_at))

    def start_prefill(g: SimGroup, now: float) -> None:
        if g.current is None and g.queue:
            i = g.queue.popleft()
            g.queued_chunks -= chunks_of(i)
            g.current = i
            g.busy_until = max(now, g.avail_at) + \
                chunks_of(i) * g.t_prefill_chunk

    def admit(now: float) -> None:
        # Strict FIFO head-of-line, like the controller's pending deque.
        while pending and pending[0][0] <= now:
            cands = [g for g in decode_groups()
                     if g.avail_at <= now and not g.draining
                     and len(g.active) < g.decode_slots]
            if not cands:
                return
            g = min(cands, key=lambda g: (len(g.active) * g.t_decode_step,
                                          g.gid))
            _, i = pending.popleft()
            R[i].emit(now)  # first token rides the handed-off logits
            left = R[i].gen - R[i].generated
            if left > 0:
                g.active[i] = left
                if g.next_tick == _INF:
                    g.next_tick = now + g.t_decode_step

    def kill(g: SimGroup, now: float) -> None:
        g.alive = False
        victims = list(g.queue) + \
            ([g.current] if g.current is not None else []) + \
            list(g.active)
        g.queue.clear()
        g.queued_chunks = 0
        g.current, g.busy_until = None, _INF
        g.active.clear()
        g.next_tick = _INF
        # Tickets handed off FROM a dead prefill group are gone with its
        # pool; they re-prefill too.
        for ready, i in list(pending):
            if R[i].done_at is None and i in victims:
                pending.remove((ready, i))
        for i in victims:
            if R[i].done_at is None:
                delayed.append((now + detect_delay, i))
        delayed.sort()

    def flip(g: SimGroup, to_role: str, now: float) -> None:
        nonlocal n_flips
        displaced = []
        if g.role == "prefill":
            displaced = list(g.queue) + \
                ([g.current] if g.current is not None else [])
            g.queue.clear()
            g.queued_chunks = 0
            g.current = None
        g.role = to_role
        g.avail_at = now + flip_delay
        g.busy_until = _INF
        g.next_tick = _INF
        g.draining = False
        g.flips += 1
        n_flips += 1
        for i in displaced:  # forced flips may displace queued prefills
            route_prefill(i, now)

    def control(now: float) -> None:
        # Pressure signals are WAIT-based, not instantaneous counts — a
        # momentary ticket spike that decode would drain in a step must
        # not cost a flip (flips pay flip_delay of lost service).
        dec = decode_groups()
        pre = prefill_groups()
        head_wait = (now - pending[0][0]) if pending and \
            pending[0][0] <= now else 0.0
        backlog = max((backlog_s(g) for g in pre), default=0.0)
        if head_wait > wait_hi and len(pre) > 1:
            # Decode is the bottleneck: tickets are stuck. Undo any staged
            # decode→prefill flip first, then add a decode group.
            for g in dec:
                g.draining = False
            idle = [g for g in pre if g.idle() and g.avail_at <= now]
            if idle:  # len(pre) > 1 already: never strand future arrivals
                flip(min(idle, key=lambda g: (g.t_decode_step, g.gid)),
                     "decode", now)
            return
        if backlog > backlog_s_hi and head_wait == 0.0 and len(dec) > 1:
            # Prefill is the bottleneck: add a prefill group. An idle
            # decode group flips now; otherwise stage a drain on the
            # least-loaded one (admissions skip it; it flips when empty).
            if not any(g.draining for g in dec):
                g = min(dec, key=lambda g: (len(g.active),
                                            g.t_prefill_chunk, g.gid))
                if g.active:
                    g.draining = True
                elif g.avail_at <= now:
                    flip(g, "prefill", now)
                    return
        elif backlog < 0.25 * backlog_s_hi:
            for g in dec:
                g.draining = False
        for g in list(dec):
            if g.draining and not g.active and g.avail_at <= now \
                    and len(decode_groups()) > 1:
                flip(g, "prefill", now)
                break

    for _ in range(max_events):
        # -- next event time --
        cand = []
        if a_ptr < len(arrivals):
            cand.append(R[arrivals[a_ptr]].arrival)
        if k_ptr < len(kill_list):
            cand.append(kill_list[k_ptr][0])
        if delayed:
            cand.append(delayed[0][0])
        cand += [g.busy_until for g in groups if g.current is not None]
        cand += [g.next_tick for g in groups if g.active]
        free = [g for g in decode_groups()
                if not g.draining and len(g.active) < g.decode_slots]
        if pending and free:
            cand.append(max(pending[0][0],
                            min(g.avail_at for g in free)))
        if elastic and (pending or any(not g.idle() for g in groups)):
            cand.append(next_ctrl)
        # stalled-but-flipping groups become usable at avail_at
        if pending or delayed or a_ptr < len(arrivals):
            cand += [g.avail_at for g in groups
                     if g.alive and g.avail_at > t]
        nxt = min((c for c in cand if c < _INF), default=_INF)
        if nxt == _INF:
            break
        t = max(t, nxt)

        # 1. failures first: death is detected at the tick boundary.
        while k_ptr < len(kill_list) and kill_list[k_ptr][0] <= t:
            gid = kill_list[k_ptr][1]
            if by_gid[gid].alive:
                kill(by_gid[gid], t)
            k_ptr += 1
            if elastic and not decode_groups():
                pre = [g for g in prefill_groups() if g.idle()] or \
                    prefill_groups()
                if len(prefill_groups()) > 1 and pre:
                    flip(min(pre, key=lambda g: g.gid), "decode", t)
        # 2. recovered work re-enters the router.
        while delayed and delayed[0][0] <= t:
            _, i = delayed.pop(0)
            route_prefill(i, t)
        # 3. arrivals (SLO admission sheds provably-late ones at the door:
        #    the best ETA over live prefill groups — queue drain + own
        #    chunks + any flip latency — already blows the TTFT budget).
        while a_ptr < len(arrivals) and R[arrivals[a_ptr]].arrival <= t:
            i = arrivals[a_ptr]
            a_ptr += 1
            if slo_admission and slo_ttft < _INF:
                etas = [backlog_s(g) + chunks_of(i) * g.t_prefill_chunk
                        + max(g.avail_at - t, 0.0)
                        for g in prefill_groups()]
                if etas and min(etas) > slo_ttft:
                    n_shed += 1
                    continue
            route_prefill(i, t)
        # 4. prefill completions -> tickets.
        for g in groups:
            while g.alive and g.role == "prefill" and \
                    g.current is not None and g.busy_until <= t:
                pending.append((g.busy_until + t_handoff, g.current))
                g.current, g.busy_until = None, _INF
                start_prefill(g, t)
        # 5. decode steps.
        for g in groups:
            while g.alive and g.role == "decode" and g.active and \
                    g.next_tick <= t:
                now = g.next_tick
                for i in list(g.active):
                    R[i].emit(now)
                    g.active[i] -= 1
                    if g.active[i] <= 0 or R[i].done_at is not None:
                        del g.active[i]
                g.next_tick = now + g.t_decode_step if g.active else _INF
        # 6. admissions at the new time.
        admit(t)
        for g in prefill_groups():
            start_prefill(g, t)
        # 7. elastic control.
        if elastic and next_ctrl <= t:
            control(t)
            while next_ctrl <= t:
                next_ctrl += control_dt
    else:
        raise RuntimeError("simulate_fleet_trace: max_events exceeded")

    done = [r for r in R if r.done_at is not None]
    good = [r for r in done
            if (r.ttft or 0.0) <= slo_ttft and r.max_itl <= slo_itl]
    makespan = max((r.done_at for r in done), default=0.0)
    tok = sum(r.generated for r in done)
    tok_good = sum(r.generated for r in good)
    return FleetSimResult(
        makespan=makespan,
        goodput=tok / makespan if makespan > 0 else 0.0,
        goodput_under_slo=tok_good / makespan if makespan > 0 else 0.0,
        ttft_p99=percentile([r.ttft for r in R if r.ttft is not None], 0.99),
        itl_p99=percentile([r.max_itl for r in done], 0.99),
        n_requests=len(R), n_finished=len(done), n_good=len(good),
        n_flips=n_flips, n_shed=n_shed)
