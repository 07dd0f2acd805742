"""Elastic multi-group serving fleet (mirror of ``repro/serve/fleet``,
DESIGN.md §12)."""

from repro_torch.serve.fleet.controller import (FleetController, FleetEvent,
                                                FleetGroup, make_fleet)
from repro_torch.serve.fleet.router import FleetRouter
from repro_torch.serve.fleet.sim import (FleetSimResult, SimGroup,
                                         simulate_fleet_trace)

__all__ = ["FleetController", "FleetGroup", "FleetEvent", "FleetRouter",
           "make_fleet", "SimGroup", "FleetSimResult",
           "simulate_fleet_trace"]
