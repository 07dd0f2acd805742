"""Elastic multi-group serving fleet (DESIGN.md §12; the port of the JAX
package's ``serve/fleet/controller.py``).

Scales the one-prefill/one-decode disagg controller into a FLEET: N
prefill and M decode groups of mixed device classes, each a disagg worker
over its OWN paged pool, joined by three control-plane mechanisms:

* **routing** — arrivals land on the prefill group with the least
  estimated completion time and migration tickets on the least-loaded
  decode group that has a free slot AND pool headroom
  (:class:`~repro_torch.serve.fleet.router.FleetRouter`); tickets stay
  strictly FIFO (head-of-line) so fleet metrics stay comparable to the
  single-group controller's;
* **elastic role reassignment** — when tickets back up behind decode
  (or decode groups die), an idle prefill group FLIPS into a decode
  group, and when prefill queues back up, a decode group drains and
  flips back. A flip swaps the group's worker object around the fleet's
  two shared programs — fresh pool, the old one released with the old
  worker — and is
  only taken when the group's pool is empty (``pages_in_use == 0``
  covers live tables AND outstanding ticket exports), except the forced
  path that revives a fleet with zero decode groups, which displaces the
  flipped group's queued work and re-prefills its parked tickets;
* **failure recovery** — groups heartbeat into the dormant-until-now
  ``ft.monitor`` machinery on the tick clock. A killed group stops
  beating and stops computing; after the grace window
  ``HeartbeatMonitor`` declares it dead and every in-flight request it
  held (queued, mid-prefill, parked ticket, or mid-decode) re-enters the
  router and RE-PREFILLS token-exactly: resume tokens come from the
  fleet's results log (fed by streamed ``on_token`` callbacks — exactly
  what a control plane honestly still has after a crash), and the
  ``(seed, rid, n)`` sampler discipline makes the continuation
  token-exact.
  Surviving pools are never touched, so ``BlockAllocator.check()`` holds
  throughout. ``StragglerDetector`` wall-times feed the router's
  ``slow_factor`` so degraded groups shed load before they die.

Because per-request logits depend only on the request's own tokens and
sampling keys are schedule-independent (§7.4), the whole fleet — across
routing, flips, preemptions, kills, and recovery — is TOKEN-EXACT
against the unified single-group engine on any trace.

Chaos hardening (DESIGN.md §13) layers three more mechanisms on top:

* **epoch fencing** — every group carries a ``generation`` that its
  token callbacks and migration tickets are stamped with. A group
  declared dead while actually still computing (heartbeat loss — a
  false positive) becomes a ZOMBIE: its epoch ``(gid, generation)`` is
  fenced, it is quarantined onto private results/metrics (so the fleet
  log cannot be corrupted), and every completion it keeps producing is
  rejected by the fence. When its heartbeats return it REJOINS at
  ``generation + 1`` with a fresh worker — the replacement and the
  zombie can never race because only the newest epoch passes the fence;
* **transactional handoff** — a migration whose transfer exhausts its
  retry budget rolls back cleanly (decode lease + slot inside
  ``try_admit``, source export here) and the request re-prefills
  token-exactly; a chaos crash mid-transfer kills the victim group and
  leaves the ticket head-of-line for the normal death path;
* **SLO-aware shedding** — with ``slo_ttft`` set, an arrival whose best
  achievable prefill ETA across the (possibly degraded) fleet already
  exceeds the SLO is SHED at submit: an explicit outcome the client can
  retry elsewhere, instead of a guaranteed-late finish. The run
  invariant becomes submitted ⊆ finished ∪ rejected ∪ shed.

All faults come from a seeded :class:`~repro_torch.ft.chaos.FaultInjector`
consulted at named hook points, so every failure run replays exactly
from ``(seed, spec)``.

In the port every group runs on one device and one stream, and shares ONE
compute-dtype copy of the params (``stack.compute_params``; the JAX
package places a copy per program); each group still owns its own pool
and allocator. The device classes only set the router's speed priors,
from the analytic serve profile. Token-exactness rests, as in the JAX
package, on per-request logits that depend only on the request's own
tokens: a re-prefill recomputes through chunked prefill what the first
run computed through decode steps (other kernels on the card), equal up
to rounding, so only a near-tie can flip a token; the tests hold it
under an f32 policy.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.ft.chaos import FaultInjector, GroupCrashed
from repro_torch.ft.monitor import (HeartbeatConfig, HeartbeatMonitor,
                                    StragglerDetector)
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import RunConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.disagg.workers import (DecodeWorker, MigrationTicket,
                                              PrefillWorker)
from repro_torch.serve.fleet.router import FleetRouter
from repro_torch.serve.kv_transfer import (KVTransferEngine,
                                           TransferAbortedError)
from repro_torch.serve.metrics import RequestTrace, ServeMetrics
from repro_torch.serve.scheduler import Request

PREFILL, DECODE = "prefill", "decode"


class FleetGroup:
    """One serving group: a device class + a role + a disagg worker over
    its own pool. Implements the router's group-view protocol."""

    def __init__(self, gid: int, cls: str, role: str, worker):
        self.gid = gid
        self.cls = cls
        self.role = role
        self.worker = worker
        self.alive = True
        self.draining = False   # decode→prefill flip staged
        self.flips = 0
        self.generation = 0     # fencing epoch (bumps on zombie rejoin)

    @property
    def name(self) -> str:
        return f"g{self.gid}"

    # -- router protocol ----------------------------------------------------

    def queued_prefill_tokens(self) -> int:
        sched = self.worker.sched
        n = sum(len(e.tokens) for e in sched.queue)
        if sched._prefilling is not None:
            entry, _, start, _ = sched._prefilling
            n += len(entry.tokens) - start
        return n

    def n_active(self) -> int:
        return len(self.worker.sched.running)

    def can_accept_ticket(self, n_tokens: int) -> bool:
        if self.draining or not self.worker.sched.has_free():
            return False
        alloc = self.worker.allocator
        return alloc.pages_for(n_tokens) <= alloc.n_pages - \
            alloc.pages_in_use

    # -- flip eligibility ---------------------------------------------------

    def idle(self) -> bool:
        """No scheduled work and an empty pool — pages_in_use counts live
        tables AND exported (parked-ticket) pages, so a prefill group with
        un-migrated tickets is NOT idle."""
        w = self.worker
        if self.role == PREFILL:
            busy = w.sched.has_work()
        else:
            busy = bool(w.sched.running)
        return not busy and w.allocator.pages_in_use == 0


@dataclasses.dataclass
class _Pending:
    enq_tick: int
    src_gid: int
    gen: int                 # source group's generation at enqueue
    ticket: MigrationTicket


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    tick: int
    kind: str     # 'flip' | 'dead' | 'recover' | 'rejoin' | 'shed'
    gid: int
    detail: str = ""


class FleetController:
    """Drives the group fleet through a shared tick clock."""

    def __init__(self, groups: Sequence[FleetGroup], router: FleetRouter,
                 transfer: KVTransferEngine, *,
                 make_prefill_worker: Callable[[], PrefillWorker],
                 make_decode_worker: Callable[[Dict, Callable],
                                              DecodeWorker],
                 metrics: Optional[ServeMetrics] = None,
                 elastic: bool = False, grace_ticks: int = 3,
                 wait_hi_ticks: int = 4, backlog_hi_chunks: int = 8,
                 on_token: Optional[Callable] = None,
                 chaos: Optional[FaultInjector] = None,
                 slo_ttft: Optional[float] = None,
                 agree: Optional[Callable[[float], float]] = None):
        self.groups: List[FleetGroup] = list(groups)
        # On a mesh every rank routes by rank 0's step times, so the
        # replicated control plane takes the same decisions everywhere.
        self.agree = agree or (lambda t: t)
        self.router = router
        self.transfer = transfer
        self.metrics = metrics or ServeMetrics()
        self.elastic = elastic
        self.wait_hi_ticks = wait_hi_ticks
        self.backlog_hi_chunks = backlog_hi_chunks
        self._make_prefill = make_prefill_worker
        self._make_decode = make_decode_worker
        self._user_on_token = on_token
        self.chaos = chaos
        self.slo_ttft = slo_ttft
        self.results: Dict[int, List[int]] = {}   # fleet results log
        self.finished: set = set()
        self.submitted: set = set()
        self.rejected: List[int] = []
        self.shed: List[int] = []                 # SLO-infeasible arrivals
        self.fenced: set = set()                  # dead (gid, generation)
        self.zombies: List[FleetGroup] = []       # quarantined false-deads
        self.pending: deque = deque()             # _Pending FIFO
        self.events: List[FleetEvent] = []
        self.n_flips = 0
        self.tick_count = 0
        self._dead_tracks: set = set()  # tracks of removed groups (§15)
        self.monitor = HeartbeatMonitor(
            [g.name for g in self.groups],
            HeartbeatConfig(interval_s=1.0, grace_multiplier=grace_ticks),
            clock=lambda: float(self.tick_count))
        self.detector = StragglerDetector([g.name for g in self.groups])
        if router.slow_factor is None:
            router.slow_factor = self.detector.slow_factor
        # Decode pools share one geometry (one compiled decode program),
        # so the submit-time bound survives flips and deaths.
        dec = [g for g in self.groups if g.role == DECODE]
        if not dec or not [g for g in self.groups if g.role == PREFILL]:
            raise ValueError("fleet needs >= 1 prefill and >= 1 decode "
                             "group")
        a = dec[0].worker.allocator
        self._decode_pool = (a.n_pages, a.page_size, a.max_pages_per_seq)
        # Decode schedulers share ONE results dict: the fleet control
        # plane's token log, which is what recovery resumes from.
        for g in self.groups:
            self._wire(g)

    def _wire(self, g: FleetGroup) -> None:
        # One tracer track per group (§15): both roles' spans land on
        # g{gid}, so a flip shows up as the span names changing on the
        # same track.
        g.worker.track = g.name
        g.worker.sched.track = g.name
        if g.role == DECODE:
            g.worker.sched.results = self.results
            g.worker.metrics = self.metrics
            # The fencing epoch is baked into the callback at wire time:
            # a zombie's stale worker keeps reporting under its OLD
            # (gid, gen) and is rejected, while the gen+1 replacement
            # passes — the two can never interleave in the results log.
            gid, gen = g.gid, g.generation
            g.worker.on_token = \
                lambda rid, tok, fin: self._on_token(gid, gen, rid, tok,
                                                     fin)

    def _fleet_instant(self, name: str, **args) -> None:
        """Control-plane instant on the "fleet" meta track (§15):
        excluded from idle attribution, visible in the viewer."""
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.declare_track("fleet", pid="fleet", kind="meta")
            tr.instant("fleet", name, **args)

    def _event(self, kind: str, gid: int, detail: str = "") -> None:
        self.events.append(FleetEvent(self.tick_count, kind, gid, detail))
        self._fleet_instant(kind, gid=gid, detail=detail)

    def _on_token(self, gid: int, gen: int, rid: int, tok: int,
                  finished: bool) -> None:
        if (gid, gen) in self.fenced:
            self.metrics.robust.fenced_stale_completions += 1
            return
        if finished:
            self.finished.add(rid)
        if self._user_on_token:
            self._user_on_token(rid, tok, finished)

    # -- views --------------------------------------------------------------

    def prefill_groups(self) -> List[FleetGroup]:
        return [g for g in self.groups if g.alive and g.role == PREFILL]

    def decode_groups(self) -> List[FleetGroup]:
        return [g for g in self.groups if g.alive and g.role == DECODE]

    def group(self, gid: int) -> FleetGroup:
        for g in self.groups:
            if g.gid == gid:
                return g
        raise KeyError(f"no group {gid}")

    @property
    def queue_depth(self) -> int:
        return sum(g.worker.sched.depth for g in self.prefill_groups()) \
            + len(self.pending)

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        pre = self.prefill_groups()
        total = len(req.prompt) + req.max_new_tokens
        if not pre:
            raise ValueError(f"request {req.rid}: no live prefill group")
        n_pages, page_size, max_per_seq = self._decode_pool
        if -(-total // page_size) > min(n_pages, max_per_seq):
            raise ValueError(
                f"request {req.rid}: needs more pages than a decode "
                f"pool holds")
        if self.slo_ttft is not None:
            # SLO-aware shedding (DESIGN.md §13): price the arrival with
            # the router's class-speed ETAs. If even the BEST prefill
            # group cannot reach first token inside the SLO, the degraded
            # fleet provably cannot serve it — shed now, explicitly,
            # instead of finishing late. Shed requests count as submitted
            # (the invariant is submitted ⊆ finished ∪ rejected ∪ shed)
            # but never enter the latency metrics.
            eta = min(self.router.prefill_eta(g, len(req.prompt))
                      for g in pre)
            if eta > self.slo_ttft:
                self.submitted.add(req.rid)
                self.shed.append(req.rid)
                self.metrics.robust.shed_requests += 1
                self._event("shed", -1, f"rid {req.rid}")
                return
        g = self.router.place_request(pre, len(req.prompt))
        g.worker.sched.submit(req)  # validates + prefill-pool fit
        self.submitted.add(req.rid)
        self.metrics.on_submit(req.rid, len(req.prompt))
        self._fleet_instant("route", rid=req.rid, gid=g.gid)
        obs_trace.TRACER.flow(g.name, "queued", req.rid,
                              prompt=len(req.prompt))

    # -- failure injection + recovery ---------------------------------------

    def kill_group(self, gid: int) -> None:
        """Crash a group: it stops beating and stops computing. Its state
        is unreachable from now on; recovery happens only after the
        heartbeat grace window declares it dead. Killing a quarantined
        zombie really kills it — it never rejoins."""
        for z in self.zombies:
            if z.gid == gid:
                z.alive = False
                self.zombies.remove(z)
                return
        self.group(gid).alive = False

    def _requeue(self, request: Request, resume: List[int]) -> None:
        tgt = self.router.place_request(
            self.prefill_groups(), len(request.prompt) + len(resume))
        if tgt is None:
            raise RuntimeError("no live prefill group to recover into")
        tgt.worker.sched.requeue_front(request, resume)

    def _strip_group_work(self, g: FleetGroup,
                          abort_exports: bool) -> List[Tuple]:
        """Collect (request, resume) for every in-flight request ``g``
        holds. For a LIVE group being flipped, also release its pool
        state (abort ticket exports, free mid-prefill pages); for a dead
        group the pool is unreachable and left as-is."""
        victims: List[Tuple] = []
        w = g.worker
        if g.role == PREFILL:
            sched = w.sched
            if sched._prefilling is not None:
                entry, *_ = sched._prefilling
                victims.append((entry.request, list(entry.resume)))
                if abort_exports:
                    w.allocator.free(entry.request.rid)
                sched._prefilling = None
                w.prec = None
            for entry in sched.queue:
                victims.append((entry.request, list(entry.resume)))
            sched.queue.clear()
            still = deque()
            for item in self.pending:
                if item.src_gid != g.gid:
                    still.append(item)
                    continue
                t = item.ticket
                rid = t.request.rid
                victims.append(
                    (t.request, list(t.tokens[len(t.request.prompt):])))
                if abort_exports:
                    w.allocator.abort_export(rid)
                    w.allocator.free(rid)
            self.pending = still
        else:
            for slot in sorted(w.sched.running,
                               key=lambda s: w.sched.running[s].seq):
                run = w.sched.running[slot]
                rid = run.request.rid
                victims.append((run.request, list(self.results[rid])))
            if abort_exports:
                for slot in list(w.sched.running):
                    w.sched.pop_newest()
        return victims

    def _handle_deaths(self) -> None:
        for name in self.monitor.dead_hosts():
            g = next((g for g in self.groups if g.name == name), None)
            if g is None:
                continue
            self.monitor.remove(name)
            self.detector.remove(name)
            self.groups.remove(g)
            # Declared dead while still computing (suppressed heartbeats,
            # not a crash): a ZOMBIE — the detection was a false positive
            # and the group will keep producing completions. Fence its
            # epoch and quarantine it; it may rejoin at gen+1 later.
            zombie = g.alive
            self._event("dead", g.gid,
                        g.role + (" (zombie)" if zombie else ""))
            self._dead_tracks.add(g.name)
            victims = self._strip_group_work(g, abort_exports=False)
            if zombie:
                self._quarantine(g)
            # Revive a decode-less fleet before re-routing its victims.
            if self.elastic and not self.decode_groups():
                self._force_decode_flip()
            for request, resume in victims:
                self._requeue(request, resume)
            if victims:
                self._event("recover", g.gid,
                            f"{len(victims)} requests re-prefill")

    def _quarantine(self, g: FleetGroup) -> None:
        """Fence a falsely-dead group's epoch and detach it from every
        fleet-shared structure, so the zombie can keep computing without
        corrupting the results log the replacement is rebuilding."""
        self.fenced.add((g.gid, g.generation))
        w = g.worker
        tr = obs_trace.TRACER
        if tr.enabled:
            # The zombie keeps computing: move it to a meta track (no idle
            # attribution) so the replacement owns the real g{gid} track.
            ztrack = f"{g.name}:zombie"
            tr.declare_track(ztrack, pid="fleet", kind="meta")
            w.track = ztrack
            w.sched.track = ztrack
        if g.role == DECODE:
            # Private snapshot of the results log: the zombie's scheduler
            # keeps appending (its requests are still live inside it) but
            # the fleet log only hears from it via the fenced callback,
            # which rejects everything. Same for metrics: a private,
            # seeded ServeMetrics absorbs its on_token/on_finish calls.
            w.sched.results = {rid: list(toks)
                               for rid, toks in self.results.items()}
            m = ServeMetrics()
            for run in w.sched.running.values():
                m.requests[run.request.rid] = \
                    RequestTrace(rid=run.request.rid)
            w.metrics = m
        self.zombies.append(g)

    def _maybe_rejoin_zombies(self) -> None:
        """Re-admit quarantined groups whose heartbeats returned: bump
        the generation (the fence keeps rejecting the old epoch), build a
        fresh worker + pool, and rejoin with a fresh grace window."""
        if self.chaos is None:
            return
        for z in list(self.zombies):
            if self.chaos.active("hb_loss", z.name):
                continue
            self.zombies.remove(z)
            z.generation += 1
            z.draining = False
            z.worker = self._make_decode(self.results, None) \
                if z.role == DECODE else self._make_prefill()
            self._wire(z)
            self.groups.append(z)
            self._dead_tracks.discard(z.name)
            self.monitor.add(z.name)
            self.detector.add(z.name)
            self.metrics.robust.zombie_rejoins += 1
            self._event("rejoin", z.gid, f"gen {z.generation}")

    # -- elastic role flips -------------------------------------------------

    def _flip(self, g: FleetGroup, to_role: str) -> None:
        if to_role == DECODE:
            g.worker = self._make_decode(self.results, self._on_token)
        else:
            g.worker = self._make_prefill()
        g.role = to_role
        g.draining = False
        g.flips += 1
        self.n_flips += 1
        self._wire(g)
        self._event("flip", g.gid, f"-> {to_role}")

    def _force_decode_flip(self) -> None:
        """Zero decode groups left: conscript a prefill group, displacing
        its queued work and parked tickets onto the survivors."""
        pre = self.prefill_groups()
        if len(pre) < 2:
            return
        g = min(pre, key=lambda g: (g.queued_prefill_tokens(), g.gid))
        displaced = self._strip_group_work(g, abort_exports=True)
        self._flip(g, DECODE)
        for request, resume in displaced:
            self._requeue(request, resume)

    def _elastic_tick(self) -> None:
        pre, dec = self.prefill_groups(), self.decode_groups()
        head_wait = (self.tick_count - self.pending[0].enq_tick) \
            if self.pending else 0
        backlog = max((-(-g.queued_prefill_tokens()
                         // g.worker.sched.prefill_chunk)
                       for g in pre), default=0)
        if head_wait > self.wait_hi_ticks and len(pre) > 1:
            # Decode-bound: tickets are stuck. Cancel staged drains, then
            # flip an idle prefill group (fastest decode class first).
            for g in dec:
                g.draining = False
            idle = [g for g in pre if g.idle()]
            if idle:
                dspeed = self.router.decode_speed
                self._flip(min(idle, key=lambda g:
                               (-dspeed.get(g.cls, 1.0), g.gid)), DECODE)
            return
        if backlog > self.backlog_hi_chunks and head_wait == 0 \
                and len(dec) > 1:
            # Prefill-bound: flip an idle decode group now, else stage a
            # drain on the least-loaded one (router stops feeding it).
            if not any(g.draining for g in dec):
                pspeed = self.router.prefill_speed
                g = min(dec, key=lambda g: (g.n_active(),
                                            -pspeed.get(g.cls, 1.0),
                                            g.gid))
                if g.idle():
                    self._flip(g, PREFILL)
                    return
                g.draining = True
        elif backlog <= max(self.backlog_hi_chunks // 4, 1):
            for g in dec:
                g.draining = False
        for g in dec:
            if g.draining and g.idle() and len(self.decode_groups()) > 1:
                self._flip(g, PREFILL)
                break

    # -- one fleet tick -----------------------------------------------------

    def tick(self) -> None:
        chaos = self.chaos
        tr = obs_trace.TRACER
        tr.advance(self.tick_count)
        if tr.enabled:
            tr.declare_track("fleet", pid="fleet", kind="meta")
            for g in self.groups:
                tr.declare_track(g.name, pid="fleet")
        if chaos is not None:
            chaos.begin_tick(self.tick_count)
            for g in list(self.groups):
                if g.alive and chaos.fire("crash_start", g.name):
                    self.kill_group(g.gid)
        for g in self.groups:
            if g.alive and not (chaos is not None
                                and chaos.active("hb_loss", g.name)):
                self.monitor.beat(g.name)
        self._handle_deaths()
        self._maybe_rejoin_zombies()
        for g in self.prefill_groups():
            t0 = time.perf_counter()
            for ticket in g.worker.step():
                self.pending.append(_Pending(self.tick_count, g.gid,
                                             g.generation, ticket))
            self.detector.record(
                g.name, self.agree(time.perf_counter() - t0))
            if chaos is not None \
                    and chaos.fire("crash_post_prefill", g.name):
                self.kill_group(g.gid)
        while self.pending:
            # FIFO, head-of-line: a stuck head keeps its place in line.
            item = self.pending[0]
            if (item.src_gid, item.gen) in self.fenced:
                # A fenced epoch's ticket: its request was already
                # re-routed when the group was declared dead — landing it
                # too would double-serve. Drop, count, move on.
                self.pending.popleft()
                self.metrics.robust.fenced_stale_tickets += 1
                continue
            src = next((g for g in self.groups
                        if g.gid == item.src_gid), None)
            if src is None or not src.alive:
                # Source crashed with the ticket parked: its pool is
                # unreachable, so the ticket cannot migrate. Hold the
                # line — the death path collects and re-prefills it once
                # the grace window expires.
                break
            tgt = self.router.place_ticket(self.decode_groups(),
                                           len(item.ticket.tokens))
            if tgt is None:
                break
            try:
                ok = tgt.worker.try_admit(item.ticket, src.worker,
                                          self.transfer, self.tick_count,
                                          src_name=src.name,
                                          dst_name=tgt.name)
            except TransferAbortedError:
                # Retries exhausted: the decode side already rolled back
                # (lease + slot). Roll back the source export and send
                # the request down the re-prefill path — (seed, rid, n)
                # sampling keeps its continuation token-exact.
                self.pending.popleft()
                t = item.ticket
                src.worker.allocator.abort_export(t.request.rid)
                src.worker.allocator.free(t.request.rid)
                self.metrics.robust.transfer_aborts += 1
                self._requeue(t.request,
                              list(t.tokens[len(t.request.prompt):]))
                continue
            except GroupCrashed as e:
                # One end died mid-transfer. The decode rollback already
                # ran; the ticket stays head-of-line and the normal
                # death machinery (grace window -> strip -> re-prefill)
                # recovers whatever the victim held.
                victim = src if e.role == "src" else tgt
                self.kill_group(victim.gid)
                break
            if not ok:
                break
            self.pending.popleft()
        for g in self.decode_groups():
            for request, generated in g.worker.ensure_pages():
                self._requeue(request, generated)
        for g in self.decode_groups():
            if g.worker.any_active():
                t0 = time.perf_counter()
                g.worker.decode_once(self.tick_count)
                self.detector.record(
                g.name, self.agree(time.perf_counter() - t0))
        # Zombies keep computing against their private quarantine state —
        # that is exactly the race the fence exists to win. Their output
        # lands in the fenced callback and is counted, never recorded.
        for z in self.zombies:
            if z.role == DECODE:
                z.worker.ensure_pages()  # victims already re-routed
                if z.worker.any_active():
                    z.worker.decode_once(self.tick_count)
        if self.elastic:
            self._elastic_tick()
        st = self.transfer.stats
        self.metrics.robust.transfer_retries = st.n_retries
        self.metrics.robust.checksum_failures = st.n_checksum_failures
        self.metrics.on_tick(
            self.queue_depth,
            sum(g.worker.sched.n_active for g in self.decode_groups()))
        if tr.enabled:
            self._attribute_idle(tr, chaos)
        self.tick_count += 1

    def _attribute_idle(self, tr, chaos) -> None:
        """Classify this tick for every group track that did no work
        (§15). Exactly one bucket per idle group-tick; the report
        defaults unmarked ticks to queue-starved, so removed groups'
        trailing gaps are marked fault-stall here explicitly."""
        for g in self.groups:
            if tr.busy_this_tick(g.name):
                continue
            if not g.alive or (chaos is not None
                               and chaos.active("hb_loss", g.name)):
                bucket = "fault-stall"
            elif g.role == PREFILL:
                if any(p.src_gid == g.gid for p in self.pending):
                    # Pool (partly) parked behind un-migrated tickets.
                    bucket = "transfer-wait"
                elif g.worker.sched.wait_reason == "pages":
                    bucket = "pool-OOM"
                else:
                    bucket = "queue-starved"
            else:
                bucket = "drain" if g.draining else "queue-starved"
            tr.mark_idle(g.name, bucket)
        for name in self._dead_tracks:
            tr.mark_idle(name, "fault-stall")

    def has_work(self) -> bool:
        return any(g.worker.sched.has_work()
                   for g in self.prefill_groups()) \
            or bool(self.pending) \
            or any(g.worker.sched.running for g in self.decode_groups())

    # -- trace driver -------------------------------------------------------

    def run(self, requests: List[Request],
            kills: Sequence[Tuple[int, int]] = (),
            max_ticks: int = 100_000) -> Dict[int, List[int]]:
        """Drive a trace to completion. ``kills`` is [(tick, gid)] fault
        injection: the group crashes at the START of that tick (scripted
        — the seeded chaos layer injects everything else). The run is
        complete when every submitted request has finished, been
        rejected, or been shed — NOT when queues look empty, because a
        crashed group's requests are invisible until the heartbeat grace
        window expires."""
        arrivals = sorted(requests, key=lambda r: r.arrival)
        kill_q = sorted(kills)
        k = 0
        while True:
            while k < len(kill_q) and kill_q[k][0] <= self.tick_count:
                self.kill_group(kill_q[k][1])
                k += 1
            while arrivals and arrivals[0].arrival <= self.tick_count:
                req = arrivals.pop(0)
                try:
                    self.submit(req)
                except ValueError:
                    self.rejected.append(req.rid)
            if not arrivals and k >= len(kill_q) \
                    and self.submitted <= (self.finished
                                           | set(self.rejected)
                                           | set(self.shed)):
                return self.results
            self.tick()
            if self.tick_count > max_ticks:
                raise RuntimeError(
                    f"fleet trace exceeded {max_ticks} ticks "
                    f"({len(self.finished)}/{len(self.submitted)} done)")


def make_fleet(cfg: ModelConfig, run: RunConfig, params, *,
               prefill_classes: Sequence[str],
               decode_classes: Sequence[str], decode_slots: int,
               max_len: int, page_size: int,
               prefill_pages: Optional[int] = None,
               decode_pages: Optional[int] = None, prefill_chunk: int = 16,
               token_budget: Optional[int] = None, seed: int = 0,
               transfer_chunk_pages: int = 4,
               link_bw: Optional[float] = None, latency_s: float = 0.0,
               metrics: Optional[ServeMetrics] = None,
               on_token: Optional[Callable] = None, elastic: bool = False,
               grace_ticks: int = 3, wait_hi_ticks: int = 4,
               backlog_hi_chunks: int = 8,
               chaos: Optional[FaultInjector] = None,
               slo_ttft: Optional[float] = None,
               transfer_max_retries: int = 3,
               device="cuda", mesh=None) -> FleetController:
    """Wire up a full fleet on one device, or on this rank of the serving
    mesh ``mesh`` (every group on the one mesh, as in the JAX package;
    the kill and chaos schedules are host-side and seeded, and the
    straggler detector records rank 0's step times on every rank, so each
    rank replays the same fleet) (the multi-group analogue of
    ``make_disagg``). ``prefill_classes`` / ``decode_classes`` name the
    device class of each initial group (keys of ``hardware.CLASSES``) —
    one group per entry; the class sets the router's speed priors via the
    analytic serve profile (§10). ONE prefill program and ONE decode
    program serve every group (and every future flip — a role flip builds
    a fresh worker + pool around the existing program), and every group
    shares ONE compute-dtype copy of ``params`` (the JAX package places a
    copy per program); each group still owns its own pool and allocator.
    """
    from repro_torch.core import profiler as P
    from repro_torch.core.hardware import CLASSES
    from repro_torch.serve.engine import _make_paged_program
    from repro_torch.serve.kv_blocks import BlockAllocator
    from repro_torch.serve.scheduler import DecodeScheduler, PrefillScheduler

    names = list(prefill_classes) + list(decode_classes)
    if not prefill_classes or not decode_classes:
        raise ValueError("fleet needs >= 1 prefill and >= 1 decode group")
    unknown = [n for n in names if n not in CLASSES]
    if unknown:
        raise ValueError(f"unknown device class(es) {unknown}; "
                         f"known: {sorted(CLASSES)}")
    if cfg.is_encdec or cfg.vision_seq > 0:
        raise ValueError("the fleet serves decoder-only LMs")
    device = torch.device(device)
    max_pages = -(-max_len // page_size)
    prefill_pages = prefill_pages if prefill_pages is not None \
        else 2 * max_pages
    pre_prog = _make_paged_program(
        cfg, run, n_slots=1, max_len=max_len, seed=seed,
        page_size=page_size, n_pages=max(prefill_pages, max_pages),
        device=device, mesh=mesh)
    dec_prog = _make_paged_program(
        cfg, run, n_slots=decode_slots, max_len=max_len, seed=seed,
        page_size=page_size, n_pages=decode_pages, device=device, mesh=mesh)
    params = dec_prog.prepare(params)
    agree = None
    if mesh is not None and mesh.size > 1:
        from repro_torch.sharding import collectives as C
        group = mesh.group(mesh.axis_names)

        def agree(t):
            return C.broadcast_host(t, group, mesh.device)

    def make_prefill_worker() -> PrefillWorker:
        sched = PrefillScheduler(
            max_len, prefill_chunk=prefill_chunk, token_budget=token_budget,
            allocator=BlockAllocator(pre_prog.n_pages, page_size,
                                     pre_prog.max_pages))
        return PrefillWorker(pre_prog, params, sched)

    def make_decode_worker(results, on_tok) -> DecodeWorker:
        sched = DecodeScheduler(
            decode_slots,
            allocator=BlockAllocator(dec_prog.n_pages, page_size,
                                     dec_prog.max_pages))
        sched.results = results
        return DecodeWorker(dec_prog, params, sched, on_token=on_tok)

    shared = ServeMetrics() if metrics is None else metrics
    groups = []
    for gid, cls in enumerate(names):
        role = PREFILL if gid < len(prefill_classes) else DECODE
        worker = make_prefill_worker() if role == PREFILL \
            else make_decode_worker({}, None)
        groups.append(FleetGroup(gid, cls, role, worker))
    prefill_speed = {n: prefill_chunk
                     / P.prefill_chunk_time(cfg, prefill_chunk, max_len,
                                            CLASSES[n])
                     for n in set(names)}
    decode_speed = {n: decode_slots
                    / P.decode_step_time(cfg, decode_slots, max_len,
                                         CLASSES[n])
                    for n in set(names)}
    router = FleetRouter(prefill_speed=prefill_speed,
                         decode_speed=decode_speed)
    transfer = KVTransferEngine(chunk_pages=transfer_chunk_pages,
                                link_bw=link_bw, latency_s=latency_s,
                                max_retries=transfer_max_retries,
                                chaos=chaos)
    return FleetController(
        groups, router, transfer,
        make_prefill_worker=make_prefill_worker,
        make_decode_worker=make_decode_worker, metrics=shared,
        elastic=elastic, grace_ticks=grace_ticks,
        wait_hi_ticks=wait_hi_ticks, backlog_hi_chunks=backlog_hi_chunks,
        on_token=on_token, chaos=chaos, slo_ttft=slo_ttft, agree=agree)
