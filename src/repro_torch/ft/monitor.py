"""Fault tolerance: heartbeats, straggler detection, elastic response
(a copy of the JAX package's ``ft/monitor.py``; it imports nothing of
either package).

Designed for 1000+ node fleets: per-host heartbeat tracking with grace
windows; per-step timing ring buffers with robust (median/MAD) outlier
detection; and a response policy that prefers *re-balancing over eviction* —
a straggling expert group is first handled by Asym-EA replanning (shift
expert work onto the healthy attention group: the same mechanism that
absorbs generation gaps absorbs degradation), and only persistent failures
trigger elastic shrink + checkpoint restore.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class HeartbeatConfig:
    interval_s: float = 10.0
    grace_multiplier: float = 3.0


class HeartbeatMonitor:
    """Host-level liveness. Hosts call beat(); the coordinator calls
    dead_hosts() each scheduling tick."""

    def __init__(self, hosts: List[str], cfg: HeartbeatConfig = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or HeartbeatConfig()
        self.clock = clock
        now = clock()
        self.last_seen: Dict[str, float] = {h: now for h in hosts}

    def beat(self, host: str):
        self.last_seen[host] = self.clock()

    def add(self, host: str):
        """Group join (fleet elasticity): starts with a fresh grace window."""
        self.last_seen[host] = self.clock()

    def remove(self, host: str):
        """Group leave / declared-dead eviction: stop tracking it so
        dead_hosts() converges after the coordinator has reacted."""
        self.last_seen.pop(host, None)

    def dead_hosts(self) -> List[str]:
        cutoff = self.clock() - self.cfg.interval_s * \
            self.cfg.grace_multiplier
        return [h for h, t in self.last_seen.items() if t < cutoff]


class StragglerDetector:
    """Per-group step-time statistics with median/MAD z-scores.

    A group whose recent step times exceed median + z_thresh * 1.4826*MAD
    for `patience` consecutive windows is flagged."""

    def __init__(self, groups: List[str], window: int = 20,
                 z_thresh: float = 4.0, patience: int = 3):
        self.window = window
        self.z = z_thresh
        self.patience = patience
        self.times: Dict[str, deque] = {g: deque(maxlen=window)
                                        for g in groups}
        self.strikes: Dict[str, int] = {g: 0 for g in groups}

    def record(self, group: str, step_time: float):
        self.times[group].append(step_time)

    def add(self, group: str):
        self.times.setdefault(group, deque(maxlen=self.window))
        self.strikes.setdefault(group, 0)

    def remove(self, group: str):
        self.times.pop(group, None)
        self.strikes.pop(group, None)

    def _stats(self):
        all_recent = [t for d in self.times.values() for t in d]
        if len(all_recent) < 4:
            return None
        s = sorted(all_recent)
        med = s[len(s) // 2]
        mad = sorted(abs(x - med) for x in s)[len(s) // 2]
        return med, max(mad, 1e-9)

    def stragglers(self) -> List[str]:
        st = self._stats()
        if st is None:
            return []
        med, mad = st
        out = []
        for g, d in self.times.items():
            if not d:
                continue
            recent = sum(list(d)[-3:]) / min(len(d), 3)
            zscore = (recent - med) / (1.4826 * mad)
            if zscore > self.z:
                self.strikes[g] += 1
            else:
                self.strikes[g] = 0
            if self.strikes[g] >= self.patience:
                out.append(g)
        return out

    def slow_factor(self, group: str) -> float:
        st = self._stats()
        if st is None or not self.times[group]:
            return 1.0
        med, _ = st
        recent = sum(list(self.times[group])[-3:]) / \
            min(len(self.times[group]), 3)
        return max(recent / med, 1.0)
