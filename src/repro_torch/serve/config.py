"""Deployment configuration + factory (mirror of ``repro/serve/config.py``,
DESIGN.md §14).

:class:`ServeConfig` is the one declarative description of a deployment
and :func:`build_deployment` the one construction path. ``validate``
reports EVERY violation in one :class:`ServeConfigError`. The port builds
the unified paged deployment (``ContinuousBatchingEngine`` over a
``BlockAllocator``); the JAX package's other deployment shapes (prefix
cache, disaggregation, expert-parallel decode, fleet, chaos) add their
sub-configs here when they are ported. Until then the driver rejects
their flags by name (``launch/serve.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.models import stack
from repro_torch.serve.engine import (ContinuousBatchingEngine,
                                      make_continuous_program)
from repro_torch.serve.kv_blocks import BlockAllocator
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Scheduler


class ServeConfigError(ValueError):
    """An invalid ServeConfig. The message lists EVERY violation
    (semicolon-joined), so one failed launch reports the whole set."""


@dataclasses.dataclass(frozen=True)
class PagedCfg:
    """Paged-KV geometry (DESIGN.md §9)."""

    enabled: bool = False
    page_size: int = 16
    pool_pages: Optional[int] = None  # default: full reservation capacity


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

    @property
    def sampling(self) -> SamplingParams:
        return SamplingParams(temperature=self.temperature,
                              top_k=self.top_k, top_p=self.top_p)

    @classmethod
    def from_args(cls, args) -> "ServeConfig":
        """Build from the launch driver's argparse namespace."""
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
                           pool_pages=args.pool_pages))

    def validate(self, model_cfg=None) -> None:
        """Reject-don't-truncate validation of the WHOLE config: every
        violation in one :class:`ServeConfigError`. ``model_cfg`` adds the
        arch-dependent checks (layer kinds the port does not run yet)."""
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
        if self.paged.page_size < 1:
            errs.append(f"page_size must be >= 1, got {self.paged.page_size}")
        if self.paged.pool_pages is not None and self.paged.pool_pages < 1:
            errs.append(f"pool_pages must be >= 1, "
                        f"got {self.paged.pool_pages}")
        if not self.paged.enabled:
            errs.append("not ported to repro_torch yet: running without "
                        "--paged (dense per-slot KV caches)")
        if model_cfg is not None:
            if model_cfg.is_encdec or model_cfg.vision_seq > 0:
                errs.append(f"{model_cfg.name}: encoder-decoder and vision "
                            f"archs are not ported yet")
            kinds = sorted({s.tag() for s in model_cfg.layer_layout()
                            if s.mixer not in ("attn", "local_attn")
                            or s.cross_attn})
            if kinds:
                errs.append(f"{model_cfg.name}: layer kinds {kinds} are not "
                            f"ported yet")
        if errs:
            raise ServeConfigError("; ".join(errs))


def build_deployment(cfg, run, serve_cfg: ServeConfig, *, params=None,
                     device="cuda", metrics=None, on_token=None,
                     record_logits: bool = False):
    """THE construction path from a :class:`ServeConfig` to a live engine:
    validate first (so an invalid config never half-constructs), then the
    unified paged deployment — ``ContinuousBatchingEngine`` over a
    ``BlockAllocator`` and a ``Scheduler``. ``params`` defaults to a fresh
    init from seed 0 on ``device`` (the JAX package's ``PRNGKey(0)``
    init)."""
    serve_cfg.validate(model_cfg=cfg)
    sc = serve_cfg
    program = make_continuous_program(cfg, run, sc, device=device)
    allocator = BlockAllocator(program.n_pages, program.page_size,
                               program.max_pages)
    sched = Scheduler(sc.slots, sc.max_len, prefill_chunk=sc.prefill_chunk,
                      token_budget=sc.token_budget, allocator=allocator)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = stack.init_model(gen, cfg, device=device)
    return ContinuousBatchingEngine(program, params, sched, metrics=metrics,
                                    on_token=on_token,
                                    record_logits=record_logits)
