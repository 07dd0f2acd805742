"""Deployment configuration + factory (mirror of ``repro/serve/config.py``,
DESIGN.md §14).

:class:`ServeConfig` is the one declarative description of a deployment
and :func:`build_deployment` the one construction path. ``validate``
reports EVERY violation in one :class:`ServeConfigError`. Config ->
engine mapping, as in the JAX package::

    encoder-decoder / vision arch -> BatchedServer        (lockstep)
    fleet.enabled                 -> FleetController      (make_fleet)
    disagg.enabled                -> DisaggController     (make_disagg)
    ep.ep_size > 0 (MoE arch)     -> EPContinuousBatchingEngine
    otherwise                     -> ContinuousBatchingEngine (dense)
    paged.enabled                 -> + BlockAllocator (paged KV, §9)
    prefix.enabled                -> + PrefixIndex (COW prefix cache, §14)

Every engine runs on a serving mesh (``build_deployment(mesh=)``, a
``launch.mesh.Mesh``; None: the 1x1 mesh of one device; ``serve.mesh``).
Expert-parallel decode (``EPCfg``, DESIGN.md §11) runs over the mesh's
"model" axis: ``validate(mesh=)`` refuses an ``ep_size`` other than its
extent with the JAX message, and the
disaggregated deployment takes EP as the JAX one does. The fleet refuses
it, as in the JAX package. Encoder-decoder and vision archs take the lockstep
``BatchedServer`` before any other branch, as in the JAX package: their
steps need per-request front embeddings that the continuous engines do
not carry, so ``--paged``, ``--disagg`` and ``--fleet`` fall through to it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.models import stack
from repro_torch.serve.engine import (BatchedServer,
                                      ContinuousBatchingEngine,
                                      make_continuous_program,
                                      make_serve_program)
from repro_torch.serve.kv_blocks import BlockAllocator
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Scheduler


class ServeConfigError(ValueError):
    """An invalid ServeConfig. The message lists EVERY violation
    (semicolon-joined), so one failed launch reports the whole set."""


def parse_group_spec(spec: str, default_cls: str) -> list:
    """``--prefill-groups``/``--decode-groups`` value: either an integer
    count (that many groups of the role's default class) or a
    comma-separated device-class list (one group per entry)."""
    items = [x.strip() for x in (spec or "").split(",") if x.strip()]
    if len(items) == 1 and items[0].isdigit():
        return [default_cls] * int(items[0])
    return items


def parse_kills(specs) -> list:
    """``--kill-group`` occurrences -> [(tick, gid)], parsed by the ONE
    fault-spec grammar (``ft.chaos.FaultPlan``): the ``GID@TICK``
    shorthand is sugar for a ``crash_start@TICK:gGID`` chaos entry, and
    the full entry form is accepted verbatim."""
    from repro_torch.ft.chaos import FaultPlan
    kills = []
    for spec in specs or ():
        raw = spec.strip()
        head = raw.split("@", 1)[0]
        if "@" in raw and head.isdigit():
            gid, tick = raw.split("@", 1)
            raw = f"crash_start@{tick}:g{gid}"
        try:
            plan = FaultPlan.parse(raw)
        except ValueError:
            raise ValueError(
                f"--kill-group wants GID@TICK (or a chaos-grammar "
                f"crash_start@TICK:gGID entry), got {spec!r}") from None
        (entry,) = plan.specs
        tgt = entry.target or ""
        if entry.site != "crash_start" or entry.tick is None \
                or not (tgt.startswith("g") and tgt[1:].isdigit()):
            raise ValueError(
                f"--kill-group wants GID@TICK (or a chaos-grammar "
                f"crash_start@TICK:gGID entry), got {spec!r}")
        kills.append((entry.tick, int(tgt[1:])))
    return kills


@dataclasses.dataclass(frozen=True)
class PagedCfg:
    """Paged-KV geometry (DESIGN.md §9). ``enabled`` switches the unified
    engine to paged mode; disagg/fleet deployments are paged inherently
    and read only the geometry fields."""

    enabled: bool = False
    page_size: int = 16
    pool_pages: Optional[int] = None          # decode/unified pool
    prefill_pool_pages: Optional[int] = None  # disagg/fleet prefill pool


@dataclasses.dataclass(frozen=True)
class PrefixCacheCfg:
    """Prefix-cached COW paged KV (DESIGN.md §14). Requires a paged
    deployment (unified ``paged`` or ``disagg``). ``fair`` switches
    admission to per-tenant deficit round-robin."""

    enabled: bool = False
    capacity_pages: Optional[int] = None  # LRU bound on pinned pages
    fair: bool = False


@dataclasses.dataclass(frozen=True)
class DisaggCfg:
    """Disaggregated prefill/decode deployment (DESIGN.md §10)."""

    enabled: bool = False
    transfer_chunk_pages: int = 4
    link_bw: Optional[float] = None
    latency_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class EPCfg:
    """Expert-parallel decode (DESIGN.md §11). ``ep_size`` == 0 is off;
    ``placement`` is ``uniform`` (static round-robin) or ``planned``
    (online heterogeneity-aware re-placement from the routing EMA)."""

    ep_size: int = 0
    placement: str = "uniform"


@dataclasses.dataclass(frozen=True)
class FleetCfg:
    """Elastic multi-group fleet (DESIGN.md §12). ``kills`` are
    (tick, gid) crash injections — see :func:`parse_kills`."""

    enabled: bool = False
    prefill_groups: Tuple[str, ...] = ("a40",)
    decode_groups: Tuple[str, ...] = ("v100",)
    elastic: bool = False
    kills: Tuple[Tuple[int, int], ...] = ()
    slo_ttft: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ChaosCfg:
    """Seeded fault schedule (DESIGN.md §13, fleet mode only)."""

    spec: Optional[str] = None
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """One declarative description of a serving deployment."""

    slots: int = 4
    max_len: int = 72
    prefill_chunk: int = 16
    token_budget: Optional[int] = None  # prefill tokens/tick (None: chunk)
    seed: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    paged: PagedCfg = PagedCfg()
    prefix: PrefixCacheCfg = PrefixCacheCfg()
    disagg: DisaggCfg = DisaggCfg()
    ep: EPCfg = EPCfg()
    fleet: FleetCfg = FleetCfg()
    chaos: ChaosCfg = ChaosCfg()

    @property
    def sampling(self) -> SamplingParams:
        return SamplingParams(temperature=self.temperature,
                              top_k=self.top_k, top_p=self.top_p)

    @property
    def any_paged(self) -> bool:
        """Whether any page machinery exists (unified paged, disagg or
        fleet — the latter two are paged inherently)."""
        return self.paged.enabled or self.disagg.enabled or self.fleet.enabled

    def ep_decode_config(self):
        """The runtime ``EPDecodeConfig`` this config describes (None when
        EP is off)."""
        if not self.ep.ep_size:
            return None
        from repro_torch.serve.ep_decode import EPDecodeConfig
        planned = self.ep.placement == "planned"
        return EPDecodeConfig(ep_size=self.ep.ep_size, n_chunks=2,
                              rebalance_every=8 if planned else 0,
                              drift_threshold=0.05)

    @classmethod
    def from_args(cls, args) -> "ServeConfig":
        """Build from the launch driver's argparse namespace. Parse-level
        problems (malformed kill specs) surface as
        :class:`ServeConfigError`, so the driver has ONE error path."""
        try:
            pre = tuple(parse_group_spec(args.prefill_groups, "a40"))
            dec = tuple(parse_group_spec(args.decode_groups, "v100"))
            kills = tuple(parse_kills(args.kill_group))
        except ValueError as e:
            raise ServeConfigError(str(e)) from None
        return cls(
            slots=args.slots,
            max_len=args.prompt_len + args.gen,
            prefill_chunk=args.prefill_chunk,
            token_budget=args.prefill_budget,
            seed=args.seed,
            temperature=args.temperature,
            top_k=args.top_k,
            top_p=args.top_p,
            paged=PagedCfg(enabled=bool(args.paged),
                           page_size=args.page_size,
                           pool_pages=args.pool_pages,
                           prefill_pool_pages=args.prefill_pool_pages),
            prefix=PrefixCacheCfg(enabled=bool(args.prefix_cache),
                                  capacity_pages=args.prefix_capacity,
                                  fair=bool(args.fair)),
            disagg=DisaggCfg(enabled=bool(args.disagg)),
            ep=EPCfg(ep_size=getattr(args, "ep_size", 0) or 0,
                     placement=getattr(args, "ep_placement", "uniform")),
            fleet=FleetCfg(enabled=bool(args.fleet), prefill_groups=pre,
                           decode_groups=dec,
                           elastic=bool(args.fleet_elastic), kills=kills,
                           slo_ttft=args.slo_ttft),
            chaos=ChaosCfg(spec=args.chaos, seed=args.chaos_seed))

    def validate(self, model_cfg=None, mesh=None) -> None:
        """Reject-don't-truncate validation of the WHOLE config: every
        violation in one :class:`ServeConfigError`. ``model_cfg`` adds the
        arch-dependent checks (recurrent-arch prefix rejection, EP on a
        dense arch); with it, ``mesh`` (its "model" axis: the EP ranks, as
        in the JAX package) adds EP's divisibility and rank-count
        checks."""
        errs: List[str] = []
        if self.slots < 1:
            errs.append(f"slots must be >= 1, got {self.slots}")
        if self.max_len < 2:
            errs.append(f"max_len must be >= 2, got {self.max_len}")
        if self.prefill_chunk < 1:
            errs.append(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.token_budget is not None and self.token_budget < 1:
            errs.append(
                f"token_budget must be >= 1, got {self.token_budget}")
        if self.any_paged:
            if self.paged.page_size < 1:
                errs.append(f"page_size must be >= 1, "
                            f"got {self.paged.page_size}")
            for name, v in (("pool_pages", self.paged.pool_pages),
                            ("prefill_pool_pages",
                             self.paged.prefill_pool_pages)):
                if v is not None and v < 1:
                    errs.append(f"{name} must be >= 1, got {v}")
        if self.fleet.enabled and self.disagg.enabled:
            errs.append("--fleet and --disagg are mutually exclusive "
                        "deployment shapes")
        if self.prefix.enabled and not (self.paged.enabled
                                        or self.disagg.enabled):
            errs.append("--prefix-cache needs a paged deployment "
                        "(--paged or --disagg)")
        if self.prefix.enabled and self.fleet.enabled:
            errs.append("--prefix-cache is not supported with --fleet "
                        "(per-group pools do not share a prefix index)")
        if self.prefix.capacity_pages is not None \
                and self.prefix.capacity_pages < 1:
            errs.append(f"prefix capacity_pages must be >= 1, "
                        f"got {self.prefix.capacity_pages}")
        if self.chaos.spec and not self.fleet.enabled:
            errs.append("--chaos requires --fleet (the chaos hook points "
                        "live in the fleet controller)")
        if self.fleet.kills and not self.fleet.enabled:
            errs.append("--kill-group requires --fleet")
        if self.fleet.slo_ttft is not None and not self.fleet.enabled:
            errs.append("--slo-ttft requires --fleet")
        if self.fleet.enabled:
            if not self.fleet.prefill_groups or not self.fleet.decode_groups:
                errs.append("fleet needs >= 1 prefill and >= 1 decode group")
            from repro_torch.core.hardware import CLASSES
            unknown = [c for c in (*self.fleet.prefill_groups,
                                   *self.fleet.decode_groups)
                       if c not in CLASSES]
            if unknown:
                errs.append(f"unknown device class(es) {unknown}; "
                            f"known: {sorted(CLASSES)}")
        if self.chaos.spec:
            from repro_torch.ft.chaos import FaultPlan
            try:
                FaultPlan.parse(self.chaos.spec)
            except ValueError as e:
                errs.append(f"bad --chaos spec: {e}")
        if self.ep.ep_size:
            if self.fleet.enabled:
                errs.append("--ep-size is not supported with --fleet")
            if self.ep.placement not in ("uniform", "planned"):
                errs.append(f"ep placement must be 'uniform' or 'planned', "
                            f"got {self.ep.placement!r}")
            if model_cfg is not None:
                if not model_cfg.is_moe:
                    errs.append(f"--ep-size needs a MoE arch; "
                                f"{model_cfg.name} is dense")
                elif mesh is not None:
                    from repro_torch.serve.ep_decode import \
                        validate_ep_config
                    try:
                        validate_ep_config(model_cfg, mesh,
                                           self.ep_decode_config())
                    except ValueError as e:
                        errs.append(f"bad EP config: {e}")
        if model_cfg is not None:
            if self.prefix.enabled:
                rec = sorted({s.mixer for s in model_cfg.layer_layout()
                              if s.mixer in ("rglru", "ssd")})
                if rec:
                    errs.append(
                        f"--prefix-cache needs per-position KV only; "
                        f"{model_cfg.name} carries recurrent mixers {rec} "
                        f"whose state depends on every earlier token, so "
                        f"skipping a cached prefix would corrupt it")
        if errs:
            raise ServeConfigError("; ".join(errs))


def build_deployment(cfg, run, serve_cfg: ServeConfig, *, params=None,
                     device="cuda", metrics=None, on_token=None,
                     record_logits: bool = False, mesh=None):
    """THE construction path from a :class:`ServeConfig` to a live engine:
    validate first (so an invalid config never half-constructs), then the
    deployment the config describes (see the module docstring).
    ``params`` defaults to a fresh init from seed 0 on ``device`` (the JAX
    package's ``PRNGKey(0)`` init). Every engine but the lockstep server of the encoder-decoder and vision archs
    exposes ``run(trace)`` and ``rejected``; the EP engines place (permute
    and shard) the replicated params themselves.

    ``mesh`` (a ``launch.mesh.Mesh``; None: one device): every engine is
    built on this rank of the serving mesh (``serve.mesh``); ``params``
    may be whole or this rank's blocks, and the seed-0 init draws each
    leaf and keeps the rank's block. Expert-parallel decode runs over the
    mesh's "model" axis."""
    from repro_torch.serve.mesh import ServeLayout, unported_on_mesh
    from repro_torch.train.step import OneDevice
    if mesh is not None and mesh.size > 1 and unported_on_mesh(cfg):
        raise ServeConfigError("not ported to repro_torch yet: a mesh "
                               "other than 1x1 for "
                               + unported_on_mesh(cfg))
    serve_cfg.validate(model_cfg=cfg,
                       mesh=mesh if mesh is not None else OneDevice())
    sc = serve_cfg
    if params is None:
        if mesh is not None and mesh.size > 1 and not sc.ep.ep_size:
            params = ServeLayout(cfg, mesh, n_slots=sc.slots,
                                 max_len=sc.max_len, dtype=None,
                                 device=device).init_params(0)
        else:
            gen = torch.Generator(device=device).manual_seed(0)
            params = stack.init_model(gen, cfg, device=device)

    if cfg.is_encdec or cfg.vision_seq > 0:
        # Lockstep fallback: enc-dec / vision archs need per-request front
        # embeddings the continuous engines do not carry.
        program = make_serve_program(cfg, run, mesh=mesh, device=device)
        return BatchedServer(program, params, sc.slots, sc.max_len)

    if sc.fleet.enabled:
        from repro_torch.serve.fleet import make_fleet
        chaos = None
        if sc.chaos.spec:
            from repro_torch.ft.chaos import FaultInjector, FaultPlan
            chaos = FaultInjector(FaultPlan.parse(sc.chaos.spec),
                                  seed=sc.chaos.seed)
        return make_fleet(
            cfg, run, params,
            prefill_classes=list(sc.fleet.prefill_groups),
            decode_classes=list(sc.fleet.decode_groups),
            decode_slots=sc.slots, max_len=sc.max_len,
            page_size=sc.paged.page_size, decode_pages=sc.paged.pool_pages,
            prefill_pages=sc.paged.prefill_pool_pages,
            prefill_chunk=sc.prefill_chunk, token_budget=sc.token_budget,
            seed=sc.seed, metrics=metrics, on_token=on_token,
            elastic=sc.fleet.elastic, chaos=chaos,
            slo_ttft=sc.fleet.slo_ttft, device=device, mesh=mesh)

    if sc.disagg.enabled:
        from repro_torch.serve.disagg import make_disagg
        return make_disagg(
            cfg, run, params, decode_slots=sc.slots, max_len=sc.max_len,
            page_size=sc.paged.page_size, decode_pages=sc.paged.pool_pages,
            prefill_pages=sc.paged.prefill_pool_pages,
            prefill_chunk=sc.prefill_chunk, token_budget=sc.token_budget,
            seed=sc.seed,
            transfer_chunk_pages=sc.disagg.transfer_chunk_pages,
            link_bw=sc.disagg.link_bw, latency_s=sc.disagg.latency_s,
            metrics=metrics, on_token=on_token,
            record_logits=record_logits, ep=sc.ep_decode_config(),
            prefix=sc.prefix, device=device, mesh=mesh)

    program = make_continuous_program(cfg, run, sc, device=device,
                                      ep=sc.ep_decode_config(), mesh=mesh)
    allocator = prefix_index = None
    if sc.paged.enabled:
        allocator = BlockAllocator(program.n_pages, program.page_size,
                                   program.max_pages)
        if sc.prefix.enabled:
            from repro_torch.serve.prefix_index import PrefixIndex
            prefix_index = PrefixIndex(
                allocator, capacity_pages=sc.prefix.capacity_pages)
    sched = Scheduler(sc.slots, sc.max_len, prefill_chunk=sc.prefill_chunk,
                      token_budget=sc.token_budget, allocator=allocator,
                      prefix_index=prefix_index, fair=sc.prefix.fair)
    if program.ep is not None:
        from repro_torch.serve.ep_decode import EPContinuousBatchingEngine
        return EPContinuousBatchingEngine(
            program, params, sched, metrics=metrics, on_token=on_token,
            record_logits=record_logits)
    return ContinuousBatchingEngine(program, params, sched, metrics=metrics,
                                    on_token=on_token,
                                    record_logits=record_logits)
