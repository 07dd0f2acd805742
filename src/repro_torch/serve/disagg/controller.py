"""Disaggregated prefill/decode serving controller (DESIGN.md §10; the
port of the JAX package's ``serve/disagg/controller.py``).

The router + two-level scheduler over one :class:`PrefillWorker` and one
:class:`DecodeWorker`:

  level 1 (prefill admission): requests enter the PREFILL queue and are
      admitted by the prefill pool's page budget (PrefillScheduler);
  level 2 (decode admission): finished prefills park as migration
      tickets and move to decode FIFO, gated by a free decode slot AND
      enough decode-pool pages for the full prompt — the KV crosses as
      pages through the transfer engine, the table rewrite makes it
      addressable, and the source pages recycle.

One controller ``tick`` mirrors the unified engine's: prefill chunks up
to the token budget, then migrations, then decode page growth (pool OOM
preempts newest back to RE-PREFILL — the victim's pages free on both
sides and it replays prompt+generated through the prefill worker;
(seed, rid, n) sampling keeps the continuation token-exact), then one
batched decode step. Because per-request logits depend only on the
request's own tokens (attention is per-row, the serve MoE path is
dropless) and sampling noise is schedule-independent, the disagg
deployment is greedy/sampled TOKEN-EXACT against the unified
ContinuousBatchingEngine on any trace — pinned by
tests/test_torch_serve_disagg.py.

Head-of-line migration: tickets migrate strictly FIFO (a stuck head does
not let younger tickets overtake), matching the unified engine's FIFO
admission so queue metrics stay comparable.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from repro_torch.models import stack
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import RunConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.disagg.workers import (DecodeWorker, MigrationTicket,
                                              PrefillWorker)
from repro_torch.serve.engine import _make_paged_program
from repro_torch.serve.kv_blocks import BlockAllocator
from repro_torch.serve.kv_transfer import (KVTransferEngine,
                                           TransferAbortedError)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import (DecodeScheduler, PrefillScheduler,
                                         Request)


class DisaggController:
    """Drives the role-split workers through a shared tick clock."""

    def __init__(self, prefill: PrefillWorker, decode: DecodeWorker,
                 transfer: KVTransferEngine, *,
                 metrics: Optional[ServeMetrics] = None):
        self.prefill = prefill
        self.decode = decode
        self.transfer = transfer
        self.metrics = metrics or decode.metrics
        self.decode.metrics = self.metrics
        self.pending: List[MigrationTicket] = []  # finished, unmigrated
        self.rejected: List[int] = []
        self.tick_count = 0
        self.owns_clock = True  # standalone: this controller advances the
        #                         tracer
        self.n_full_hits = 0  # prefix-cache full hits routed straight
        #                       to decode (zero KV transfer, §14)

    def set_tracks(self, prefill_track: str, decode_track: str) -> None:
        """Rename the two role tracks and cede the tick clock to the
        caller."""
        self.prefill.track = prefill_track
        self.prefill.sched.track = prefill_track
        self.decode.track = decode_track
        self.decode.sched.track = decode_track
        self.owns_clock = False

    # -- submission ---------------------------------------------------------

    @property
    def results(self) -> Dict[int, List[int]]:
        return self.decode.sched.results

    @property
    def logits(self):
        return self.decode.logits

    def submit(self, req: Request) -> None:
        """Admit to the prefill queue. Validates against BOTH pools: the
        prefill pool must hold the worst-case re-prefill (prompt +
        generated on a late preemption) and the decode pool the full
        sequence — otherwise preemption could never clear room."""
        total = len(req.prompt) + req.max_new_tokens
        if not self.decode.allocator.fits_pool(total):
            self.prefill.sched.n_rejected += 1
            raise ValueError(
                f"request {req.rid}: needs more pages than the decode "
                f"pool holds")
        self.prefill.sched.submit(req)  # validates + prefill-pool fit
        self.metrics.on_submit(req.rid, len(req.prompt))
        obs_trace.TRACER.flow(self.prefill.track, "queued", req.rid,
                              prompt=len(req.prompt))

    # -- one controller tick ------------------------------------------------

    def tick(self) -> None:
        tr = obs_trace.TRACER
        if self.owns_clock:
            tr.advance(self.tick_count)
        self._admit_full_hits()
        self.pending.extend(self.prefill.step())
        while self.pending:
            # FIFO, head-of-line: a stuck head keeps its place in line.
            try:
                if not self.decode.try_admit(self.pending[0], self.prefill,
                                             self.transfer,
                                             self.tick_count):
                    break
            except TransferAbortedError:
                # Transfer exhausted its retries: the decode side already
                # rolled back (lease + slot). Roll back the source export
                # and send the request down the existing re-prefill path —
                # (seed, rid, n) sampling keeps its continuation exact.
                t = self.pending.pop(0)
                rid = t.request.rid
                self.prefill.allocator.abort_export(rid)
                self.prefill.allocator.free(rid)
                self.metrics.robust.transfer_aborts += 1
                self.prefill.sched.requeue_front(
                    t.request, list(t.tokens[len(t.request.prompt):]))
                continue
            self.pending.pop(0)
        for request, generated in self.decode.ensure_pages():
            self.prefill.sched.requeue_front(request, generated)
        if self.decode.any_active():
            self.decode.decode_once(self.tick_count)
        st = self.transfer.stats
        self.metrics.robust.transfer_retries = st.n_retries
        self.metrics.robust.checksum_failures = st.n_checksum_failures
        self.metrics.on_tick(self.queue_depth, self.decode.sched.n_active)
        if tr.enabled:
            # Per-role idle attribution (§15): a role track that opened no
            # span this tick gets exactly one idle bucket.
            if not tr.busy_this_tick(self.prefill.track):
                bucket = "pool-OOM" \
                    if self.prefill.sched.wait_reason == "pages" \
                    else "queue-starved"
                tr.mark_idle(self.prefill.track, bucket)
            if not tr.busy_this_tick(self.decode.track):
                bucket = "transfer-wait" if self.pending \
                    else "queue-starved"
                tr.mark_idle(self.decode.track, bucket)
            tr.count(self.prefill.track, "queue_depth", self.queue_depth)
        self.tick_count += 1

    def _admit_full_hits(self) -> None:
        """Route prefix-cache FULL hits straight to decode (§14): a queued
        request whose prompt (minus the always-prefilled last token) is
        entirely resident in the DECODE pool's prefix index skips the
        prefill worker AND the KV transfer — the decode worker mounts the
        shared pages and runs the 1-token completion itself. Scans the
        whole queue (a full hit behind a cold head should not wait for the
        head's prefill), admitting in FIFO order among the hits;
        non-hits keep their positions."""
        sched = self.prefill.sched
        if self.decode.sched.prefix_index is None or not sched.queue:
            return
        i = 0
        while i < len(sched.queue):
            if not self.decode.sched.has_free():
                return
            entry = sched.queue[i]
            if self.decode.try_admit_cached(
                    entry.request, entry.tokens, len(entry.resume),
                    self.tick_count):
                del sched.queue[i]
                self.n_full_hits += 1
                obs_trace.TRACER.instant(self.decode.track, "full-hit",
                                         rid=entry.request.rid)
            else:
                i += 1

    @property
    def queue_depth(self) -> int:
        return self.prefill.sched.depth + len(self.pending)

    def has_work(self) -> bool:
        return self.prefill.sched.has_work() or bool(self.pending) \
            or bool(self.decode.sched.running)

    # -- trace driver -------------------------------------------------------

    def run(self, requests: List[Request], max_ticks: int = 100_000):
        """Drive a trace to completion (same contract as the unified
        engine's ``run``: arrivals in engine ticks, inadmissible requests
        are recorded in ``rejected`` and skipped)."""
        pending = sorted(requests, key=lambda r: r.arrival)
        while True:
            while pending and pending[0].arrival <= self.tick_count:
                req = pending.pop(0)
                try:
                    self.submit(req)
                except ValueError:
                    self.rejected.append(req.rid)
            if not pending and not self.has_work() \
                    and not self.decode.any_active():
                return self.results
            self.tick()
            if self.tick_count > max_ticks:
                raise RuntimeError(f"serve trace exceeded {max_ticks} ticks")


def make_disagg(cfg: ModelConfig, run: RunConfig, params, *,
                decode_slots: int, max_len: int, page_size: int,
                prefill_pages: Optional[int] = None,
                decode_pages: Optional[int] = None,
                prefill_chunk: int = 16,
                token_budget: Optional[int] = None, seed: int = 0,
                transfer_chunk_pages: int = 4,
                link_bw: Optional[float] = None, latency_s: float = 0.0,
                metrics: Optional[ServeMetrics] = None,
                on_token: Optional[Callable] = None,
                record_logits: bool = False, ep=None,
                ep_placement=None, prefix=None,
                device="cuda", mesh=None) -> DisaggController:
    """Wire up the full disaggregated deployment on one device, or on this
    rank of the serving mesh ``mesh`` (both workers on the one mesh, as in
    the JAX package; each rank holds its blocks of both pools and of the
    one parameter tree).

    Both workers get their own paged program + pool + allocator (the
    prefill pool defaults to TWO max-length sequences — the mid-flight
    batch-1 prompt plus parked-ticket headroom; the decode pool defaults
    to full reservation capacity) and share ONE compute-dtype copy of
    ``params`` (``stack.compute_params``; the JAX package places a copy
    per group). The role split is logical; the inter-group link lives in
    the transfer engine's cost model.

    ``ep`` (a ``serve.ep_decode.EPDecodeConfig``) shards the expert
    weights over the EP ranks, the mesh's "model" axis (DESIGN.md §11):
    BOTH programs are built with
    EP (the prefill worker shares the ranks, so its expert hop uses the
    placed weights too), the params are placed once under
    ``ep_placement`` (default ``ep.placement``, else round-robin), and the
    decode worker's routed-copy histograms feed a RoutingEMA exposed at
    ``controller.decode.routing_ema``.

    ``prefix`` (a ``serve.config.PrefixCacheCfg``) attaches a
    :class:`~repro_torch.serve.prefix_index.PrefixIndex` to the DECODE
    pool only (DESIGN.md §14): decode-side registration feeds it, full
    hits bypass prefill and the transfer entirely
    (``DisaggController._admit_full_hits``), and its ``fair`` flag
    switches the prefill queue to per-tenant deficit round-robin. The
    prefill pool never shares pages — its exports require refcount 1.
    """
    if cfg.is_encdec or cfg.vision_seq > 0:
        raise ValueError("disaggregated serving supports decoder-only LMs")
    device = torch.device(device)
    max_pages = -(-max_len // page_size)
    prefill_pages = prefill_pages if prefill_pages is not None \
        else 2 * max_pages
    pre_prog = _make_paged_program(
        cfg, run, n_slots=1, max_len=max_len, seed=seed,
        page_size=page_size, n_pages=max(prefill_pages, max_pages),
        device=device, ep=ep, mesh=mesh)
    dec_prog = _make_paged_program(
        cfg, run, n_slots=decode_slots, max_len=max_len, seed=seed,
        page_size=page_size, n_pages=decode_pages, device=device, ep=ep,
        mesh=mesh)
    params = stack.compute_params(params, run.policy)
    if ep is not None:
        from repro_torch.core.asym_ea import round_robin_placement
        from repro_torch.serve.ep_decode import place_params
        pl = ep_placement if ep_placement is not None else ep.placement
        if pl is None:
            pl = round_robin_placement(cfg.n_experts, ep.ep_size)
        params = place_params(params, cfg, pl, dec_prog.ep_group)
    params = dec_prog.prepare(params)  # this rank's blocks
    caching = prefix is not None and getattr(prefix, "enabled", False)
    pre_sched = PrefillScheduler(
        max_len, prefill_chunk=prefill_chunk, token_budget=token_budget,
        allocator=BlockAllocator(pre_prog.n_pages, page_size,
                                 pre_prog.max_pages),
        fair=caching and prefix.fair)
    dec_alloc = BlockAllocator(dec_prog.n_pages, page_size,
                               dec_prog.max_pages)
    prefix_index = None
    if caching:
        from repro_torch.serve.prefix_index import PrefixIndex
        prefix_index = PrefixIndex(dec_alloc,
                                   capacity_pages=prefix.capacity_pages)
    dec_sched = DecodeScheduler(decode_slots, allocator=dec_alloc,
                                prefix_index=prefix_index)
    prefill = PrefillWorker(pre_prog, params, pre_sched)
    decode = DecodeWorker(dec_prog, params, dec_sched, metrics=metrics,
                          on_token=on_token, record_logits=record_logits)
    if ep is not None:
        from repro_torch.serve.metrics import RoutingEMA
        decode.routing_ema = RoutingEMA(cfg.n_experts, decay=ep.ema_decay)
    transfer = KVTransferEngine(chunk_pages=transfer_chunk_pages,
                                link_bw=link_bw, latency_s=latency_s)
    return DisaggController(prefill, decode, transfer, metrics=metrics)
