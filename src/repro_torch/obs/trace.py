"""Deterministic span/event tracer on the engines' tick clock (§15; a
copy of the JAX package's ``obs/trace.py``: in the port the train
driver's step counter is the clock).

Every serving engine in this repo already carries an integer tick counter
(``ContinuousBatchingEngine.tick_count``, ``DisaggController.tick_count``,
``FleetController.tick_count``); the tracer adopts that counter as its time
base, so a trace is a pure function of the request trace + seeds — two runs
of the same seeded workload produce bit-identical event sequences (the same
determinism contract ``ft.chaos.FaultInjector.log_signature`` keeps for
fault logs). Wall-clock readings are OPT-IN annotations (``wall=True``)
layered on top; they never participate in ordering or idle attribution.

Timestamps: one tick is ``TICK_US`` microseconds of Perfetto time; events
within a tick are separated by a per-tick emission counter, so intra-tick
ordering in the viewer is exactly emission order. Simulated timelines
(``obs.zebra``) use seconds-domain tracks instead (``span_at``); the two
domains live under different pids and never mix arithmetic.

Disabled-by-default, zero cost when off: the module-level ``TRACER`` is a
``NullTracer`` whose methods are empty; hot paths call
``trace.TRACER.begin(...)`` unconditionally and pay one attribute lookup +
one no-op call per event when tracing is off. Nothing in the tracer touches
RNG state or engine control flow, so enabling it cannot perturb tokens
(tests assert bit-identical outputs either way).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time as _time
from typing import Dict, List, Optional, Tuple

TICK_US = 1_000_000  # one engine tick == 1s of Perfetto time

#: Idle-attribution buckets (§15): every idle tick of every track lands in
#: exactly one of these, so per track sum(buckets) == ticks - busy exactly.
IDLE_BUCKETS = ("queue-starved", "pool-OOM", "a2a-exposed", "transfer-wait",
                "drain", "fault-stall")


@dataclasses.dataclass
class Event:
    """One trace event. ``ph`` follows the Chrome trace-event phases this
    repo emits: B/E (span begin/end), i (instant), s/t/f (flow),
    C (counter)."""

    __slots__ = ("ph", "track", "name", "ts", "tick", "args", "eid",
                 "parent", "flow_id")

    ph: str
    track: str
    name: str
    ts: float
    tick: Optional[int]
    args: dict
    eid: int
    parent: Optional[int]   # eid of the innermost open span (flows/instants)
    flow_id: Optional[int]  # request id for s/t/f events


class NullTracer:
    """The disabled tracer: every method is an inert stub so instrumented
    hot paths cost one no-op call when tracing is off."""

    __slots__ = ()
    enabled = False

    def advance(self, tick):
        pass

    def declare_track(self, track, pid="serve", kind="tick", sort=None):
        pass

    def begin(self, track, name, **args):
        pass

    def end(self, track, **args):
        pass

    @contextlib.contextmanager
    def span(self, track, name, **args):
        yield

    def instant(self, track, name, **args):
        pass

    def flow(self, track, stage, rid, **args):
        pass

    def count(self, track, name, value):
        pass

    def mark_idle(self, track, bucket, **args):
        pass

    def span_at(self, track, name, t0, t1, **args):
        pass

    def busy_this_tick(self, track):
        return False


NULL = NullTracer()

#: The current tracer. Hot paths read ``trace.TRACER`` at call time (never
#: ``from ... import TRACER``, which would freeze the binding).
TRACER = NULL


def install(tracer) -> None:
    """Install ``tracer`` as the process-wide current tracer (None -> off)."""
    global TRACER
    TRACER = tracer if tracer is not None else NULL


def current():
    return TRACER


@contextlib.contextmanager
def use(tracer):
    """Scoped install/uninstall (tests; the launch drivers use install())."""
    prev = TRACER
    install(tracer)
    try:
        yield tracer
    finally:
        install(prev)


class Tracer:
    """The enabled tracer. See the module docstring for the contract."""

    enabled = True

    def __init__(self, wall: bool = False):
        self.wall = wall
        self.events: List[Event] = []
        self.tracks: Dict[str, dict] = {}
        self._now: int = 0          # current tick
        self._sub: int = 0          # intra-tick emission counter
        self._eid: int = 0
        self.max_tick: int = 0
        self._stacks: Dict[str, List[Tuple[int, Event]]] = {}
        self._last_busy: Dict[str, int] = {}
        self._flow_seen: set = set()
        from repro_torch.obs.registry import Registry
        self.registry = Registry()

    # -- clock ------------------------------------------------------------

    def advance(self, tick: int) -> None:
        """Advance the tick clock. Called once per engine/controller tick;
        re-advancing to the CURRENT tick is a no-op (a controller and the
        engines it drives share one clock, and resetting the intra-tick
        counter would reorder the controller's earlier events)."""
        if tick == self._now:
            return
        self._now = tick
        self._sub = 0
        if tick > self.max_tick:
            self.max_tick = tick

    @property
    def now(self) -> int:
        return self._now

    def _ts(self) -> float:
        ts = self._now * TICK_US + self._sub
        self._sub += 1
        return ts

    # -- track metadata ---------------------------------------------------

    def declare_track(self, track: str, pid: str = "serve",
                      kind: str = "tick", sort: Optional[int] = None):
        """Register track metadata. ``kind``: "tick" (engine tick clock,
        idle-attributed per tick), "time" (simulated seconds), "comm"
        (simulated link stream — overlap with its spans classifies a gap
        as a2a-exposed), "meta" (control-plane, excluded from the idle
        report)."""
        if track not in self.tracks:
            self.tracks[track] = {"pid": pid, "kind": kind,
                                  "sort": len(self.tracks) if sort is None
                                  else sort}

    def _ensure(self, track: str):
        if track not in self.tracks:
            self.declare_track(track)

    # -- span / instant / flow / counter emission -------------------------

    def _emit(self, ph, track, name, ts, tick, args, parent=None,
              flow_id=None) -> Event:
        ev = Event(ph, track, name, ts, tick, args, self._eid, parent,
                   flow_id)
        self._eid += 1
        self.events.append(ev)
        return ev

    def _open(self, track):
        st = self._stacks.get(track)
        return st[-1][0] if st else None

    def begin(self, track: str, name: str, **args) -> None:
        """Open a span on ``track`` at the current tick."""
        self._ensure(track)
        if self.wall:
            args["wall_s"] = _time.perf_counter()
        ev = self._emit("B", track, name, self._ts(), self._now, args,
                        parent=self._open(track))
        self._stacks.setdefault(track, []).append((ev.eid, ev))
        if self.tracks[track]["kind"] == "tick":
            self._last_busy[track] = self._now

    def end(self, track: str, **args) -> None:
        """Close the innermost open span on ``track``."""
        st = self._stacks.get(track)
        if not st:
            raise ValueError(f"end() with no open span on track {track!r}")
        eid, b = st.pop()
        if self.wall:
            args["wall_s"] = _time.perf_counter()
        self._emit("E", track, b.name, self._ts(), self._now, args,
                   parent=eid)
        if self.tracks[track]["kind"] == "tick":
            self._last_busy[track] = self._now

    @contextlib.contextmanager
    def span(self, track: str, name: str, **args):
        self.begin(track, name, **args)
        try:
            yield
        finally:
            self.end(track)

    def instant(self, track: str, name: str, **args) -> None:
        self._ensure(track)
        self._emit("i", track, name, self._ts(), self._now, args,
                   parent=self._open(track))

    def flow(self, track: str, stage: str, rid, **args) -> None:
        """Request-lifecycle flow event (queued -> ... -> finished). The
        first stage seen for ``rid`` emits a flow-start, "finished" a
        flow-finish, everything else a flow-step; each rides on an instant
        (its ``parent``) so it is visible and anchored even outside a span,
        and additionally references the innermost open span when one
        exists."""
        self._ensure(track)
        anchor = self._open(track)
        if anchor is None:
            self.instant(track, stage, rid=rid, **args)
            anchor = self.events[-1].eid
        # A flow always opens with "s" on its first stage — even if that
        # stage is "finished" (a dangling "f" with no "s" would be an
        # unanchored arrow in the viewer); "f" only terminates a started
        # flow.
        if rid not in self._flow_seen:
            ph = "s"
        elif stage == "finished":
            ph = "f"
        else:
            ph = "t"
        self._flow_seen.add(rid)
        self._emit(ph, track, stage, self._ts(), self._now,
                   dict(args, rid=rid), parent=anchor, flow_id=rid)

    def count(self, track: str, name: str, value) -> None:
        self._ensure(track)
        self._emit("C", track, name, self._ts(), self._now,
                   {"value": value})

    # -- idle attribution hooks -------------------------------------------

    def mark_idle(self, track: str, bucket: str, **args) -> None:
        """Attribute the current tick of ``track`` to one idle bucket.
        Engines call this when a tick did no work on that track; the
        report (obs.report.idle_report) falls back to queue-starved for
        unmarked idle ticks."""
        assert bucket in IDLE_BUCKETS, bucket
        self._ensure(track)
        self._emit("i", track, "idle", self._ts(), self._now,
                   dict(args, bucket=bucket), parent=self._open(track))

    def busy_this_tick(self, track: str) -> bool:
        """Whether ``track`` opened/closed any span during the current
        tick (controllers use this to decide which groups to mark idle)."""
        return self._last_busy.get(track) == self._now

    # -- simulated-time spans (obs.zebra) ---------------------------------

    def span_at(self, track: str, name: str, t0: float, t1: float,
                **args) -> None:
        """Complete span on a seconds-domain track (simulated timelines).
        ``t0``/``t1`` are seconds; stored as Perfetto microseconds."""
        self._ensure(track)
        b = self._emit("B", track, name, t0 * 1e6, None, args)
        self._emit("E", track, name, t1 * 1e6, None, {}, parent=b.eid)

    # -- introspection ----------------------------------------------------

    def signature(self) -> str:
        """sha256 over the deterministic event sequence (wall-clock args
        excluded) — the trace analogue of FaultInjector.log_signature."""
        import hashlib
        h = hashlib.sha256()
        for ev in self.events:
            args = {k: v for k, v in sorted(ev.args.items())
                    if k != "wall_s"}
            h.update(repr((ev.ph, ev.track, ev.name, ev.ts, ev.tick,
                           args, ev.eid, ev.parent, ev.flow_id)).encode())
        return h.hexdigest()
