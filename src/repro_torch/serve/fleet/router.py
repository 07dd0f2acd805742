"""Fleet request/ticket routing (DESIGN.md §12; a copy of the JAX
package's ``serve/fleet/router.py``, which imports nothing of either
package).

The router is the fleet's placement policy, deliberately host-only and
duck-typed: it scores *group views* — anything exposing the small
protocol below — so the same policy runs over real
:class:`~repro_torch.serve.fleet.controller.FleetGroup` objects and over plain
test stubs. Scores are estimated completion times, not queue lengths:
a queue of three requests on a fast class beats an empty queue on a
class three times slower.

Group protocol (prefill candidates)::

    g.gid, g.cls                  # id + device-class name
    g.queued_prefill_tokens()     # backlog ahead of a new arrival

Group protocol (decode candidates)::

    g.gid, g.cls
    g.n_active()                  # occupied decode slots
    g.can_accept_ticket(n_tokens) # free slot AND pool headroom

Speed priors are per-class scalars (tokens/s; any consistent unit).
``slow_factor`` is an optional callable (``StragglerDetector.slow_factor``
in the real controller): a degraded group's effective speed is divided by
it, steering load away from stragglers before they are evicted.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


class FleetRouter:
    """Places arrivals on prefill groups and tickets on decode groups."""

    def __init__(self, prefill_speed: Optional[Dict[str, float]] = None,
                 decode_speed: Optional[Dict[str, float]] = None,
                 slow_factor: Optional[Callable[[str], float]] = None):
        self.prefill_speed = prefill_speed or {}
        self.decode_speed = decode_speed or {}
        self.slow_factor = slow_factor

    def _slow(self, name: str) -> float:
        return max(self.slow_factor(name), 1.0) if self.slow_factor else 1.0

    # -- scoring ------------------------------------------------------------

    def prefill_eta(self, g, n_tokens: int) -> float:
        """Estimated seconds until a new ``n_tokens`` prompt finishes
        prefilling on ``g`` (queue-ahead + own work, over class speed)."""
        speed = self.prefill_speed.get(g.cls, 1.0) / self._slow(g.name)
        return (g.queued_prefill_tokens() + n_tokens) / max(speed, 1e-12)

    def decode_eta(self, g) -> float:
        """Estimated per-token latency a ticket would see on ``g``:
        occupancy over class speed (a fuller, slower group serves each
        slot's token later)."""
        speed = self.decode_speed.get(g.cls, 1.0) / self._slow(g.name)
        return (g.n_active() + 1) / max(speed, 1e-12)

    # -- placement ----------------------------------------------------------

    def place_request(self, groups, n_tokens: int):
        """Least-ETA prefill group for a new prompt (None if no groups)."""
        cands = list(groups)
        if not cands:
            return None
        return min(cands, key=lambda g: (self.prefill_eta(g, n_tokens),
                                         g.gid))

    def place_ticket(self, groups, n_tokens: int):
        """Least-ETA decode group that can land an ``n_tokens`` ticket NOW
        (free slot + pool headroom). None when nothing can — the caller
        keeps the ticket at the head of its FIFO (head-of-line)."""
        cands = [g for g in groups if g.can_accept_ticket(n_tokens)]
        if not cands:
            return None
        return min(cands, key=lambda g: (self.decode_eta(g), g.gid))
