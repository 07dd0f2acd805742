"""Unified counters/gauges registry (§15; a copy of the JAX package's
``obs/registry.py``).

Before this existed every metrics holder kept its own shape:
``serve.metrics.ServeMetrics`` (latency traces + queue gauges),
``RobustnessCounters`` (chaos-recovery counters synced off the transfer
engine), ``RoutingEMA`` (per-layer routing mass). The registry does not
replace any of them — it is the one namespace they RE-REGISTER into, so an
exporter (or a debugger at a breakpoint) can snapshot every counter in the
process with one call, and the trace JSON carries the final values next to
the event timeline.

Providers are lazy: ``register(name, fn)`` stores a zero-arg callable and
``snapshot()`` invokes them all, so registering costs nothing per tick and
the values are read exactly when asked for (end of run, or on demand).
"""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    """Named snapshot providers + explicit scalar counters/gauges."""

    def __init__(self):
        self._providers: Dict[str, Callable[[], dict]] = {}
        self._scalars: Dict[str, float] = {}

    # -- provider interface (ServeMetrics / RobustnessCounters / ...) -----

    def register(self, name: str, snapshot_fn: Callable[[], dict]) -> None:
        """Register (or replace) a named snapshot provider. ``snapshot_fn``
        returns a JSON-trivial dict when the registry is snapshot."""
        self._providers[name] = snapshot_fn

    def unregister(self, name: str) -> None:
        self._providers.pop(name, None)

    # -- scalar interface --------------------------------------------------

    def inc(self, name: str, delta: float = 1.0) -> None:
        self._scalars[name] = self._scalars.get(name, 0.0) + delta

    def set(self, name: str, value: float) -> None:
        self._scalars[name] = value

    def get(self, name: str, default: float = 0.0) -> float:
        return self._scalars.get(name, default)

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> dict:
        """One merged view: ``{"scalars": {...}, "<provider>": {...}}``.
        Provider failures surface as an ``error`` entry rather than
        tearing down an export at the end of an otherwise-good run."""
        out: dict = {}
        if self._scalars:
            out["scalars"] = dict(sorted(self._scalars.items()))
        for name, fn in self._providers.items():
            try:
                out[name] = fn()
            except Exception as e:  # pragma: no cover - defensive
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out
