"""Chrome-trace / Perfetto JSON exporter (§15; a copy of the JAX
package's ``obs/export.py``).

Writes the object form of the Chrome trace-event format
(``{"traceEvents": [...], ...}``), which both chrome://tracing and
ui.perfetto.dev load directly. Mapping:

* tracer pids ("serve", "fleet", "zebra-sim", "train") -> trace processes,
  named via ``process_name`` metadata events;
* tracks -> threads within their pid, named via ``thread_name`` metadata,
  ordered by declaration (``thread_sort_index``);
* spans -> complete "X" events (B/E pairs are joined here via the explicit
  parent eid, so out-of-order simulated timelines export correctly and a
  dangling open span — a crash mid-span — is closed at the trace horizon);
* instants -> "i" (thread scope), flows -> "s"/"t"/"f" sharing ``id``
  per request, counters -> "C".

The exporter also embeds two repo-specific top-level keys (legal per the
spec, ignored by viewers): ``reproCounters`` (the obs registry snapshot)
and ``reproIdle`` (the idle-attribution report) — so one artifact carries
the timeline, the final counters, and the idle accounting together.
``benchmarks/check_trace.py`` validates this exact shape in CI.
"""

from __future__ import annotations

import json
from typing import Optional

from repro_torch.obs.report import idle_report


def to_chrome(tracer, ticks: Optional[int] = None) -> dict:
    """Convert a Tracer to the Chrome trace-event object form."""
    pids = {}
    events = []

    def pid_of(name):
        if name not in pids:
            pids[name] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[name], "tid": 0,
                           "args": {"name": name}})
        return pids[name]

    tids = {}
    for track, meta in tracer.tracks.items():
        pid = pid_of(meta["pid"])
        tid = meta["sort"] + 1
        tids[track] = (pid, tid)
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": track}})
        events.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                       "tid": tid, "args": {"sort_index": meta["sort"]}})

    # Join B/E pairs into X events (parent eid on E names its B).
    opens = {}
    max_ts = max((ev.ts for ev in tracer.events), default=0.0)
    closed = {}
    for ev in tracer.events:
        if ev.ph == "B":
            opens[ev.eid] = ev
        elif ev.ph == "E" and ev.parent in opens:
            b = opens.pop(ev.parent)
            closed[b.eid] = (b, ev.ts, ev.args)
    for eid, b in opens.items():
        closed[eid] = (b, max_ts, {"unclosed": True})

    def clean(args):
        return {k: v for k, v in args.items() if v is not None}

    for ev in tracer.events:
        if ev.track not in tids:
            continue
        pid, tid = tids[ev.track]
        if ev.ph == "B":
            b, t1, eargs = closed[ev.eid]
            events.append({"ph": "X", "name": ev.name, "pid": pid,
                           "tid": tid, "ts": ev.ts,
                           "dur": max(t1 - ev.ts, 1e-3),
                           "args": clean({**ev.args, **eargs})})
        elif ev.ph == "E":
            continue
        elif ev.ph == "i":
            events.append({"ph": "i", "name": ev.name, "pid": pid,
                           "tid": tid, "ts": ev.ts, "s": "t",
                           "args": clean(ev.args)})
        elif ev.ph in ("s", "t", "f"):
            e = {"ph": ev.ph, "name": "req", "cat": "request",
                 "pid": pid, "tid": tid, "ts": ev.ts,
                 "id": str(ev.flow_id), "args": clean(ev.args)}
            if ev.ph == "f":
                e["bp"] = "e"  # bind to enclosing slice
            events.append(e)
        elif ev.ph == "C":
            events.append({"ph": "C", "name": ev.name, "pid": pid,
                           "tid": tid, "ts": ev.ts, "args": ev.args})

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "reproCounters": tracer.registry.snapshot(),
        "reproIdle": idle_report(tracer, ticks=ticks),
    }


def write_chrome_trace(tracer, path: str,
                       ticks: Optional[int] = None) -> dict:
    """Export ``tracer`` to ``path`` as Perfetto-loadable JSON; returns
    the exported object (the launch drivers print its idle report)."""
    obj = to_chrome(tracer, ticks=ticks)
    with open(path, "w") as f:
        json.dump(obj, f)
        f.write("\n")
    return obj
