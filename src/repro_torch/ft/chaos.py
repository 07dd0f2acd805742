"""Deterministic fault injection for the serving fleet (DESIGN.md §13; a
copy of the JAX package's ``ft/chaos.py``: the fleet controller and the
KV transfer engine consult it, the serve driver arms it from
``--chaos``).

A chaos run is fully determined by ``(seed, spec)``: the spec names WHICH
faults can fire (site, target, arming tick, probability, budget) and the
seed drives the only randomness (per-opportunity coin flips), so any
failure observed once replays identically — the injector's event log is
the proof, and ``log_signature()`` is the one-line fingerprint CI can
compare across runs.

Spec grammar (entries joined by ``;``)::

    SITE[@TICK][:TARGET][%PROB][*COUNT][~DURATION]

* ``SITE`` — one of the named hook points below;
* ``@TICK`` — armed from that controller tick on (default: immediately);
* ``:TARGET`` — a group name (``g3``) or ``*`` (default) for any target.
  Link-fault sites (drop/corrupt/stall) are matched against the
  RECEIVING group's name;
* ``%PROB`` — per-opportunity firing probability in (0, 1] (default 1);
* ``*COUNT`` — total firing budget (default 1);
* ``~DURATION`` — window length in ticks, ``hb_loss`` only (default 1).

Sites (the hook points the serving stack consults):

===================== ====================================================
``drop``              transfer chunk lost on the wire (receiver timeout)
``corrupt``           transfer chunk arrives bit-flipped (checksum catch)
``stall``             link stall after delivery: the ack is lost and the
                      sender must replay the chunk (idempotent re-apply)
``hb_loss``           heartbeats suppressed for ``~DURATION`` ticks while
                      the group keeps computing — the zombie/flap window
``crash_start``       group crashes at the start of a tick
``crash_post_prefill`` group crashes right after its prefill step
``crash_mid_export``  source group crashes between transfer chunks
``crash_mid_import``  destination group crashes between transfer chunks
===================== ====================================================

Malformed specs raise ``ValueError`` at parse time — the driver turns
that into a non-zero exit, never a silently-ignored fault plan.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import re
from typing import List, Optional, Tuple

LINK_SITES = ("drop", "corrupt", "stall")
CRASH_SITES = ("crash_start", "crash_post_prefill", "crash_mid_export",
               "crash_mid_import")
WINDOW_SITES = ("hb_loss",)
SITES = LINK_SITES + CRASH_SITES + WINDOW_SITES

_ENTRY = re.compile(
    r"^(?P<site>[a-z_]+)"
    r"(?:@(?P<tick>\d+))?"
    r"(?::(?P<target>\w+|\*))?"
    r"(?:%(?P<prob>[0-9.]+))?"
    r"(?:\*(?P<count>\d+))?"
    r"(?:~(?P<duration>\d+))?$")


class GroupCrashed(Exception):
    """A chaos crash fired mid-transfer. ``role`` says which end died
    ('src' | 'dst'); ``name`` is the group name the spec targeted."""

    def __init__(self, role: str, name: str):
        super().__init__(f"{role} group {name} crashed mid-transfer")
        self.role = role
        self.name = name


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed spec entry."""

    site: str
    tick: Optional[int] = None   # armed at tick >= this (None: always)
    target: str = "*"
    prob: float = 1.0
    count: int = 1
    duration: int = 1            # window sites only

    def matches(self, site: str, target: str) -> bool:
        return self.site == site \
            and (self.target == "*" or self.target == target)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fired fault — the replayable event-log record."""

    tick: int
    site: str
    target: str
    seq: int   # firing order, global across sites

    def as_tuple(self) -> Tuple[int, str, str, int]:
        return (self.tick, self.site, self.target, self.seq)


class FaultPlan:
    """An ordered list of :class:`FaultSpec` parsed from a spec string."""

    def __init__(self, specs: List[FaultSpec]):
        self.specs = list(specs)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        if not spec or not spec.strip():
            raise ValueError("empty chaos spec")
        specs = []
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            m = _ENTRY.match(raw)
            if m is None:
                raise ValueError(f"malformed chaos entry {raw!r} "
                                 f"(want SITE[@TICK][:TARGET][%PROB]"
                                 f"[*COUNT][~DURATION])")
            site = m.group("site")
            if site not in SITES:
                raise ValueError(f"unknown chaos site {site!r}; "
                                 f"known: {', '.join(SITES)}")
            tick = int(m.group("tick")) if m.group("tick") else None
            target = m.group("target") or "*"
            try:
                prob = float(m.group("prob")) if m.group("prob") else 1.0
            except ValueError:
                raise ValueError(f"bad probability in {raw!r}") from None
            count = int(m.group("count")) if m.group("count") else 1
            duration = int(m.group("duration")) \
                if m.group("duration") else 1
            if not 0.0 < prob <= 1.0:
                raise ValueError(f"probability must be in (0, 1], "
                                 f"got {prob} in {raw!r}")
            if count < 1:
                raise ValueError(f"count must be >= 1 in {raw!r}")
            if duration < 1:
                raise ValueError(f"duration must be >= 1 in {raw!r}")
            if m.group("duration") and site not in WINDOW_SITES:
                raise ValueError(f"~DURATION only applies to window "
                                 f"sites {WINDOW_SITES}, not {site!r}")
            if site in WINDOW_SITES and tick is None:
                raise ValueError(f"{site} needs an explicit @TICK "
                                 f"(the window start) in {raw!r}")
            if site in CRASH_SITES + WINDOW_SITES and target == "*":
                raise ValueError(f"{site} needs an explicit :TARGET "
                                 f"group in {raw!r}")
            specs.append(FaultSpec(site=site, tick=tick, target=target,
                                   prob=prob, count=count,
                                   duration=duration))
        if not specs:
            raise ValueError("empty chaos spec")
        return cls(specs)


class FaultInjector:
    """Seeded runtime half of the chaos layer.

    The serving stack calls ``begin_tick`` once per controller tick, then
    ``fire(site, target)`` at every hook point (consumes one opportunity;
    True means the fault happens NOW) and ``active(site, target)`` for
    window sites like heartbeat loss. All randomness comes from one
    seeded RNG consumed in call order, so the same ``(seed, spec)``
    against the same deterministic workload replays to an identical
    event log.
    """

    def __init__(self, plan: FaultPlan, seed: int = 0):
        self.plan = plan
        self.seed = seed
        self.rng = random.Random(seed)
        self.tick = 0
        self.events: List[FaultEvent] = []
        self._remaining = [s.count for s in plan.specs]
        self._windows_logged: set = set()

    def begin_tick(self, tick: int) -> None:
        self.tick = tick

    def _armed(self, spec: FaultSpec) -> bool:
        return spec.tick is None or self.tick >= spec.tick

    def fire(self, site: str, target: str = "*") -> bool:
        """Consume one fault opportunity at hook ``site`` for ``target``.
        Window sites never fire point-wise (use ``active``)."""
        for i, spec in enumerate(self.plan.specs):
            if spec.site in WINDOW_SITES or self._remaining[i] <= 0 \
                    or not spec.matches(site, target) \
                    or not self._armed(spec):
                continue
            if spec.prob < 1.0 and self.rng.random() >= spec.prob:
                continue
            self._remaining[i] -= 1
            self.events.append(FaultEvent(self.tick, site, target,
                                          len(self.events)))
            self._trace(site, target)
            return True
        return False

    def _trace(self, site: str, target: str) -> None:
        """Mirror a fired fault as an instant on the "chaos" meta track
        (obs §15) so the Perfetto timeline shows every injection."""
        from repro_torch.obs import trace as obs_trace
        tr = obs_trace.TRACER
        if tr.enabled:
            tr.declare_track("chaos", pid="fleet", kind="meta")
            tr.instant("chaos", site, target=target, seq=len(self.events))

    def active(self, site: str, target: str = "*") -> bool:
        """Whether a window fault (``hb_loss``) covers the current tick
        for ``target``. The window opening is logged once."""
        for spec in self.plan.specs:
            if spec.site not in WINDOW_SITES \
                    or not spec.matches(site, target):
                continue
            if spec.tick <= self.tick < spec.tick + spec.duration:
                key = (id(spec), target)
                if key not in self._windows_logged:
                    self._windows_logged.add(key)
                    self.events.append(FaultEvent(self.tick, site, target,
                                                  len(self.events)))
                    self._trace(site, target)
                return True
        return False

    # -- replay proof --------------------------------------------------------

    def log(self) -> List[Tuple[int, str, str, int]]:
        return [e.as_tuple() for e in self.events]

    def log_signature(self) -> str:
        """Stable fingerprint of the event log: equal signatures mean the
        same faults fired at the same ticks in the same order."""
        blob = ";".join(f"{t}:{s}:{g}:{q}" for t, s, g, q in self.log())
        return hashlib.sha256(blob.encode()).hexdigest()[:16]
