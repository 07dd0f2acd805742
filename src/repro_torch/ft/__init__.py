"""Fault tolerance of the port (mirror of ``repro/ft``): heartbeats,
straggler detection and the elastic controller that replans through
``repro_torch.core.planner.replan``.

The JAX package's ``ft/chaos.py`` (deterministic fault injection) is not
here yet: it serves the serving fleet and its transfer engine, which the
port does not have; it comes with them.
"""

from repro_torch.ft.elastic import ElasticController, ElasticEvent
from repro_torch.ft.monitor import (HeartbeatConfig, HeartbeatMonitor,
                                    StragglerDetector)

__all__ = ["ElasticController", "ElasticEvent", "HeartbeatConfig",
           "HeartbeatMonitor", "StragglerDetector"]
