"""Serving metrics: queue depth, time-to-first-token, inter-token latency,
throughput (DESIGN.md §7).

Wall-clock times come from a injectable ``clock`` (default
``time.perf_counter``); engine ticks are recorded alongside so tests can
assert scheduling behaviour (interleaving, slot recycling) without
depending on timing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RequestTrace:
    rid: int
    prompt_len: int = 0
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    first_token_tick: Optional[int] = None
    finish_tick: Optional[int] = None
    n_generated: int = 0
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def itl(self) -> List[float]:
        """Inter-token latencies (gaps between consecutive tokens)."""
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]


def percentile(xs: List[float], q: float) -> float:
    """Exact host-side percentile with linear interpolation (the SLO gate
    arithmetic — numpy-free so the fleet simulator can import it without
    device deps). ``q`` in [0, 1]; nan on empty input."""
    if not xs:
        return float("nan")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    s = sorted(xs)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def percentiles(xs: List[float], qs=(0.5, 0.95, 0.99)) -> Dict[str, float]:
    """{"p50": ..., "p95": ..., "p99": ...} over one sorted pass. Every
    percentile in this module goes through :func:`percentile` — the one
    exact-rank implementation (a nearest-rank `_pctl` twin used to live
    here; keep it dead)."""
    return {f"p{int(q * 100)}": percentile(xs, q) for q in qs}


@dataclasses.dataclass
class RobustnessCounters:
    """Failure-path accounting (DESIGN.md §13) — every fault the serving
    stack absorbed rather than surfaced, reported in bench summaries."""

    transfer_retries: int = 0         # chunk re-attempts after any fault
    checksum_failures: int = 0        # corrupted chunks caught + retried
    transfer_aborts: int = 0          # transfers rolled back to re-prefill
    shed_requests: int = 0            # SLO-infeasible arrivals shed
    fenced_stale_completions: int = 0  # zombie tokens rejected by epoch
    fenced_stale_tickets: int = 0     # zombie tickets dropped at admission
    zombie_rejoins: int = 0           # falsely-dead groups re-admitted

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ServeMetrics:
    """Aggregates per-request traces + per-tick engine state."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.requests: Dict[int, RequestTrace] = {}
        self.queue_depths: List[int] = []
        self.active_counts: List[int] = []
        self.robust = RobustnessCounters()
        self._t0: Optional[float] = None

    # -- event hooks (called by the engine) ---------------------------------

    def on_submit(self, rid: int, prompt_len: int) -> None:
        now = self.clock()
        if self._t0 is None:
            self._t0 = now
        self.requests[rid] = RequestTrace(rid=rid, prompt_len=prompt_len,
                                          submit_time=now)

    def on_token(self, rid: int, tick: int) -> None:
        now = self.clock()
        tr = self.requests[rid]
        if tr.first_token_time is None:
            tr.first_token_time = now
            tr.first_token_tick = tick
        tr.token_times.append(now)
        tr.n_generated += 1

    def on_finish(self, rid: int, tick: int) -> None:
        tr = self.requests[rid]
        tr.finish_time = self.clock()
        tr.finish_tick = tick

    def on_tick(self, queue_depth: int, n_active: int) -> None:
        self.queue_depths.append(queue_depth)
        self.active_counts.append(n_active)

    # -- aggregates ---------------------------------------------------------

    def summary(self) -> dict:
        done = [t for t in self.requests.values() if t.finish_time is not None]
        ttfts = [t.ttft for t in done if t.ttft is not None]
        itls = [g for t in done for g in t.itl]
        n_tok = sum(t.n_generated for t in done)
        wall = (max(t.finish_time for t in done) - self._t0) \
            if done and self._t0 is not None else float("nan")
        return {
            "n_requests": len(done),
            "n_generated_tokens": n_tok,
            "wall_s": round(wall, 4) if wall == wall else wall,
            "tokens_per_s": round(n_tok / wall, 2) if wall and wall == wall
            and wall > 0 else float("nan"),
            "ttft_s": {"mean": _mean(ttfts), **percentiles(ttfts),
                       "max": max(ttfts) if ttfts else float("nan")},
            "itl_s": {"mean": _mean(itls), **percentiles(itls)},
            "queue_depth": {"mean": _mean(self.queue_depths),
                            "max": max(self.queue_depths, default=0)},
            "max_concurrent_active": max(self.active_counts, default=0),
            "robustness": self.robust.as_dict(),
        }


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else float("nan")


class RoutingEMA:
    """Per-layer EMA of observed MoE routing histograms (DESIGN.md §11).

    The EP decode engine feeds it one ``[n_layers, n_experts]`` count
    matrix per decode step (dead-slot copies already masked out inside the
    step). Each layer keeps an exponential moving average of its NORMALIZED
    histogram — normalizing per update keeps the EMA a distribution, so
    drift is comparable across load levels — and ``merged()`` is the
    layer-mean distribution the placement planner consumes.
    """

    def __init__(self, n_experts: int, decay: float = 0.9):
        assert 0.0 <= decay < 1.0
        self.n_experts = n_experts
        self.decay = decay
        self.hist: Dict[int, np.ndarray] = {}  # layer -> EMA distribution
        self.n_updates = 0

    def update(self, counts) -> None:
        """counts: [n_layers, n_experts] (or [n_experts] for one layer)."""
        counts = np.atleast_2d(np.asarray(counts, np.float64))
        assert counts.shape[-1] == self.n_experts, counts.shape
        for layer, row in enumerate(counts):
            tot = row.sum()
            if tot <= 0:
                continue
            p = row / tot
            old = self.hist.get(layer)
            self.hist[layer] = p if old is None \
                else self.decay * old + (1.0 - self.decay) * p
        self.n_updates += 1

    def layer(self, layer: int) -> Optional[np.ndarray]:
        return self.hist.get(layer)

    def merged(self) -> np.ndarray:
        """Layer-mean routing distribution [n_experts] (uniform if no
        updates yet — a cold planner sees no skew rather than garbage)."""
        if not self.hist:
            return np.full((self.n_experts,), 1.0 / self.n_experts)
        m = np.mean(list(self.hist.values()), axis=0)
        tot = m.sum()
        return m / tot if tot > 0 else np.full_like(m, 1.0 / len(m))

    def drift(self, reference) -> float:
        """Total-variation distance between ``merged()`` and a reference
        distribution — the online re-balance trigger."""
        ref = np.asarray(reference, np.float64)
        ref = ref / max(ref.sum(), 1e-12)
        return 0.5 * float(np.abs(self.merged() - ref).sum())
