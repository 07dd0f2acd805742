"""Elastic training controller: failure -> replan -> reshard -> resume.

The control loop a 1000-node deployment runs around the train step:

  1. StragglerDetector flags a degraded expert group           (soft)
     -> planner.replan with the measured slow_factor: Asym-EA moves expert
        chunks onto the attention group; no restart, no data loss.
  2. HeartbeatMonitor declares hosts dead                       (hard)
     -> shrink the ZP group (M' = M - lost_attn, N' = N - lost_exp),
        planner.replan validates divisibility (expert count padding if
        needed), CheckpointManager.restore re-shards the latest snapshot
        onto the new mesh (placement comes from logical axes, never device
        ids), DataLoader resumes from the recorded step.

A copy of the JAX package's ``ft/elastic.py`` with its imports rewritten
to the port (``repro_torch.core.planner.replan``). The checkpoint restore
of step 2 re-places onto one device: re-sharding onto a new mesh waits
for the port's mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.core import planner as planner_mod
from repro_torch.core.planner import ZebraPlan
from repro_torch.ft.monitor import HeartbeatMonitor, StragglerDetector
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ElasticEvent:
    kind: str  # "straggler-replan" | "shrink" | "none"
    detail: str
    plan: Optional[ZebraPlan] = None


class ElasticController:
    def __init__(self, cfg: ModelConfig, plan: ZebraPlan, global_batch: int,
                 seq_len: int, attn_hosts: List[str], exp_hosts: List[str],
                 heartbeat: Optional[HeartbeatMonitor] = None,
                 detector: Optional[StragglerDetector] = None):
        self.cfg = cfg
        self.plan = plan
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.attn_hosts = list(attn_hosts)
        self.exp_hosts = list(exp_hosts)
        self.heartbeat = heartbeat or HeartbeatMonitor(
            attn_hosts + exp_hosts)
        self.detector = detector or StragglerDetector(["attn", "exp"])

    def record_step(self, attn_time: float, exp_time: float):
        self.detector.record("attn", attn_time)
        self.detector.record("exp", exp_time)

    def tick(self) -> ElasticEvent:
        """One control-loop iteration; returns the action taken."""
        dead = set(self.heartbeat.dead_hosts())
        if dead:
            lost_a = sum(1 for h in self.attn_hosts if h in dead)
            lost_e = sum(1 for h in self.exp_hosts if h in dead)
            self.attn_hosts = [h for h in self.attn_hosts if h not in dead]
            self.exp_hosts = [h for h in self.exp_hosts if h not in dead]
            self.plan = planner_mod.replan(
                self.cfg, self.plan, self.global_batch, self.seq_len,
                lost_attn=lost_a, lost_exp=lost_e)
            return ElasticEvent(
                "shrink",
                f"lost {lost_a} attention / {lost_e} expert hosts; "
                f"new ZP group M={self.plan.zp.M} N={self.plan.zp.N}, "
                f"offload={sum(self.plan.offload)}",
                self.plan)

        slow = self.detector.stragglers()
        if "exp" in slow:
            factor = self.detector.slow_factor("exp")
            self.plan = planner_mod.replan(
                self.cfg, self.plan, self.global_batch, self.seq_len,
                slow_factor=factor)
            return ElasticEvent(
                "straggler-replan",
                f"expert group {factor:.2f}x slow; Asym-EA offload now "
                f"{sum(self.plan.offload)} experts/GPU total",
                self.plan)
        return ElasticEvent("none", "healthy")
