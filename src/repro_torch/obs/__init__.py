"""Observability spine of the port (mirror of ``repro/obs``, DESIGN.md
§15): deterministic tick-clock tracing, a unified counters/gauges
registry, Perfetto export, and idle-time attribution — the measured
counterpart to the analytic profiler/simulator stack. Disabled by
default; ``trace.install(Tracer())`` turns it on and costs nothing when
off (no-op stubs).

Jax-free copies of the JAX package's modules, imports rewritten. The
port's train driver traces with them (``--trace-out``); the serving
engines' and the MPMD engine's hooks are not in the port yet."""

from repro_torch.obs.export import to_chrome, write_chrome_trace
from repro_torch.obs.registry import Registry
from repro_torch.obs.report import format_report, idle_report
from repro_torch.obs.trace import (IDLE_BUCKETS, NULL, NullTracer, Tracer,
                             current, install, use)
from repro_torch.obs.zebra import sim_to_trace

__all__ = [
    "IDLE_BUCKETS", "NULL", "NullTracer", "Registry", "Tracer",
    "current", "format_report", "idle_report", "install", "sim_to_trace",
    "to_chrome", "use", "write_chrome_trace",
]
