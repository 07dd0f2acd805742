"""Fault tolerance of the port (mirror of ``repro/ft``): heartbeats,
straggler detection, the elastic controller that replans through
``repro_torch.core.planner.replan``, and deterministic fault injection
(``chaos.py``), which the KV transfer engine of the disaggregated
deployment consults.
"""

from repro_torch.ft.chaos import (FaultEvent, FaultInjector, FaultPlan,
                                  FaultSpec, GroupCrashed)
from repro_torch.ft.elastic import ElasticController, ElasticEvent
from repro_torch.ft.monitor import (HeartbeatConfig, HeartbeatMonitor,
                                    StragglerDetector)

__all__ = ["ElasticController", "ElasticEvent", "HeartbeatConfig",
           "HeartbeatMonitor", "StragglerDetector", "FaultEvent",
           "FaultInjector", "FaultPlan", "FaultSpec", "GroupCrashed"]
