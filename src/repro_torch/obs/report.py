"""Idle-time attribution (§15): where did each group's ticks go? (A copy
of the JAX package's ``obs/report.py``.)

HeterMoE's metric of merit is GPU idle time; this report walks a tracer's
span timeline per track and accounts for every unit of time the track was
NOT inside a busy span, bucketed into the §15 idle taxonomy:

    queue-starved   nothing to run (empty queue / pipeline warmup)
    pool-OOM        work exists but the page pool cannot back it
    a2a-exposed     waiting on the exposed residue of a dispatch/combine
    transfer-wait   decode group waiting on an inbound KV migration
    drain           group is draining toward a role flip / shutdown
    fault-stall     dead, stalled, or quarantined by a fault

Two track domains:

* tick tracks (the real engines): each tick in [0, ticks) is either busy
  (>= 1 span touched it) or idle; idle ticks take the bucket of the
  ``mark_idle`` instant the engine emitted at that tick, else default to
  queue-starved. Exactly one classification per tick, so per track
  ``sum(buckets.values()) == ticks - busy`` EXACTLY — the report can never
  under- or over-account (tests assert the identity).
* time tracks (simulated zebra timelines, seconds domain): gaps between
  spans over [0, horizon] are measured in seconds; the part of a gap that
  overlaps a busy span on any sibling "comm" track is a2a-exposed (the
  stream is provably waiting on a link), the part before the track's first
  span is queue-starved (pipeline warmup), after its last span is drain,
  and the rest queue-starved. Reconciled against
  ``simulator.exposed_comm`` in tests (within 10%).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def _spans(tracer, track: str) -> List[Tuple[float, float, Optional[int],
                                             Optional[int]]]:
    """Closed spans on ``track`` as (ts0, ts1, tick0, tick1), pairing E
    events with their B via the explicit parent eid. Dangling opens are
    closed at the track's max event ts (a crash mid-span still accounts)."""
    opens: Dict[int, object] = {}
    out = []
    max_ts = 0.0
    for ev in tracer.events:
        if ev.track != track:
            continue
        max_ts = max(max_ts, ev.ts)
        if ev.ph == "B":
            opens[ev.eid] = ev
        elif ev.ph == "E" and ev.parent in opens:
            b = opens.pop(ev.parent)
            out.append((b.ts, ev.ts, b.tick, ev.tick))
    for b in opens.values():
        out.append((b.ts, max_ts, b.tick, b.tick))
    out.sort()
    return out


def _merge(ivals):
    """Merge overlapping [t0, t1) intervals."""
    merged = []
    for t0, t1 in sorted(ivals):
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    return merged


def _overlap(t0: float, t1: float, ivals) -> float:
    return sum(max(0.0, min(t1, b) - max(t0, a)) for a, b in ivals)


def _tick_track(tracer, track: str, ticks: int) -> dict:
    busy_ticks = set()
    for _, _, k0, k1 in _spans(tracer, track):
        if k0 is None:
            continue
        busy_ticks.update(range(k0, (k1 if k1 is not None else k0) + 1))
    busy_ticks = {t for t in busy_ticks if t < ticks}
    marks: Dict[int, str] = {}
    for ev in tracer.events:
        if ev.track == track and ev.ph == "i" and ev.name == "idle":
            marks[ev.tick] = ev.args.get("bucket", "queue-starved")
    buckets: Dict[str, int] = {}
    for t in range(ticks):
        if t in busy_ticks:
            continue
        b = marks.get(t, "queue-starved")
        buckets[b] = buckets.get(b, 0) + 1
    return {"kind": "tick", "ticks": ticks, "busy": len(busy_ticks),
            "idle": ticks - len(busy_ticks), "buckets": buckets}


def _time_track(tracer, track: str, comm_ivals, horizon: float) -> dict:
    spans = [(t0, t1) for t0, t1, _, _ in _spans(tracer, track)]
    busy = _merge(spans)
    busy_s = sum(t1 - t0 for t0, t1 in busy)
    end = horizon if horizon else (busy[-1][1] if busy else 0.0)
    buckets = {}

    def add(b, v):
        if v > 1e-12:
            buckets[b] = buckets.get(b, 0.0) + v

    first = busy[0][0] if busy else end
    last = busy[-1][1] if busy else 0.0
    add("queue-starved", first)                      # warmup
    add("drain", max(0.0, end - last))               # wind-down
    prev = first
    for t0, t1 in busy:
        if t0 > prev:                                # interior gap
            a2a = _overlap(prev, t0, comm_ivals)
            add("a2a-exposed", a2a)
            add("queue-starved", (t0 - prev) - a2a)
        prev = max(prev, t1)
    total = sum(buckets.values())
    return {"kind": "time", "horizon_s": end / 1e6, "busy_s": busy_s / 1e6,
            "idle_s": (end - busy_s) / 1e6,
            "buckets": {k: v / 1e6 for k, v in buckets.items()},
            "_check": abs((end - busy_s) - total) < 1e-6}


def idle_report(tracer, ticks: Optional[int] = None) -> dict:
    """Per-track idle attribution. ``ticks`` overrides the tick horizon
    for tick tracks (default: tracer.max_tick + 1 — the number of ticks
    the clock actually advanced through). Returns
    ``{track: {kind, ticks|horizon_s, busy, idle, buckets}}``; "meta"
    tracks (control plane: chaos, router) are excluded."""
    if not getattr(tracer, "enabled", False):
        return {}
    n_ticks = ticks if ticks is not None else tracer.max_tick + 1
    comm_by_pid: Dict[str, list] = {}
    for track, meta in tracer.tracks.items():
        if meta["kind"] == "comm":
            comm_by_pid.setdefault(meta["pid"], []).extend(
                (t0, t1) for t0, t1, _, _ in _spans(tracer, track))
    horizon_by_pid: Dict[str, float] = {}
    for track, meta in tracer.tracks.items():
        if meta["kind"] in ("time", "comm"):
            for _, t1, _, _ in _spans(tracer, track):
                horizon_by_pid[meta["pid"]] = max(
                    horizon_by_pid.get(meta["pid"], 0.0), t1)
    out = {}
    for track, meta in tracer.tracks.items():
        if meta["kind"] == "tick":
            out[track] = _tick_track(tracer, track, n_ticks)
        elif meta["kind"] == "time":
            out[track] = _time_track(
                tracer, track, _merge(comm_by_pid.get(meta["pid"], [])),
                horizon_by_pid.get(meta["pid"], 0.0))
    return out


def format_report(report: dict) -> str:
    """Human-readable one-line-per-track summary for the launch drivers."""
    lines = []
    for track in sorted(report):
        r = report[track]
        if r["kind"] == "tick":
            bk = " ".join(f"{k}={v}" for k, v in sorted(r["buckets"].items()))
            lines.append(f"  {track:<12} ticks={r['ticks']} busy={r['busy']} "
                         f"idle={r['idle']}" + (f" [{bk}]" if bk else ""))
        else:
            bk = " ".join(f"{k}={v:.4f}s"
                          for k, v in sorted(r["buckets"].items()))
            lines.append(f"  {track:<12} horizon={r['horizon_s']:.4f}s "
                         f"busy={r['busy_s']:.4f}s" + (f" [{bk}]" if bk
                                                       else ""))
    return "\n".join(lines)
