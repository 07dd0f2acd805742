"""Zebra schedule -> trace converter (§15; a copy of the JAX package's
``obs/zebra.py``: the port's train driver lays the same simulated
timeline beside its step clock, as the JAX driver does, although the
port runs zebra's overlap on CUDA streams the host issues).

The zebra SPMD engine's overlap happens inside one XLA program (the chunk
pipeline is scheduled by XLA's async runtime), so there is no host-visible
per-chunk clock to instrument — exactly why HeterMoE itself validates
zebra with its simulator. This module lays the simulator's task timeline
(``core.simulator.simulate`` start/end times over the paper's four FIFO
streams) onto seconds-domain tracer tracks, one track per stream:

    <prefix>:attn_comp   attention-class compute   (kind "time")
    <prefix>:exp_comp    expert-class compute      (kind "time")
    <prefix>:link_a2e    attn->exp link, EXPOSED residue only ("comm")
    <prefix>:link_e2a    exp->attn link, EXPOSED residue only ("comm")

Link spans carry only the exposed part of each all-to-all (the simulator
prices D/C tasks via ``exposed_comm``), so the idle report's a2a-exposed
bucket — compute-track gaps overlapping link spans — reconciles against
the analytic model directly (tests hold them within 10%).
"""

from __future__ import annotations

_STREAM_KIND = {"attn_comp": "time", "exp_comp": "time",
                "link_a2e": "comm", "link_e2a": "comm"}


def sim_to_trace(sched, result, tracer, *, pid: str = "zebra-sim",
                 prefix: str = "zebra") -> None:
    """Emit the simulated zebra timeline of ``(sched, result)`` —
    a ``core.schedule.ZebraSchedule`` plus the ``SimResult`` that
    ``core.simulator.simulate`` produced for it — onto ``tracer``."""
    if not getattr(tracer, "enabled", False):
        return
    if not result.ends:
        raise ValueError("SimResult has no task end times; re-run "
                         "simulator.simulate() to populate ends")
    for stream, tasks in sched.streams.items():
        kind = _STREAM_KIND.get(stream, "time")
        track = f"{prefix}:{stream}"
        tracer.declare_track(track, pid=pid, kind=kind)
        for t in tasks:
            kind_c, phase, layer, mb = t
            t0, t1 = result.starts[t], result.ends[t]
            if t1 <= t0:  # zero-duration (fully hidden a2a, empty offload)
                continue
            tracer.span_at(track, f"{kind_c}^{phase} l{layer} mb{mb}",
                           t0, t1, layer=layer, microbatch=mb,
                           chunks=sched.n_chunks)
