"""Role-split serving workers (DESIGN.md §10; the port of the JAX
package's ``serve/disagg/workers.py``).

The HeterMoE zebra insight applied to serving: prefill is attention-heavy
and compute-bound — it belongs on the attention-strong (newer) device
group — while decode is expert/GEMM-heavy and memory-bound — it stays
efficient on the older expert group. Each worker owns its OWN paged pool
and allocator; a request's KV crosses the group boundary exactly once, as
pages (serve/kv_transfer.py), when its prefill finishes.

* :class:`PrefillWorker` — batch-1 chunked prefill into the prefill
  pool, driven by a :class:`PrefillScheduler` whose page-budget admission
  is against that pool. A finished prompt parks as a
  :class:`MigrationTicket`: its pages leave the live table for the
  allocator's EXPORTED state (owned by the pending transfer, reachable by
  no engine) and the batch-1 recurrent carry + final-position logits ride
  along host-side. The single prefill stream is immediately free for the
  next request — migration backpressure shows up as pool pressure, not
  stream pressure.
* :class:`DecodeWorker` — the decode half of the continuous-batching
  engine (per-slot positions, page tables, sampled decode) minus any
  prefill path. Admission = import pages into the decode pool + ship the
  payload + insert the recurrent carry + page-table rewrite; pool OOM
  preempts newest and hands the victim BACK for re-prefill (the
  controller requeues it at the prefill queue front; (seed, rid, n)
  sampling makes the resume token-exact, §7.4).

Both workers are driven by :class:`~repro_torch.serve.disagg.controller.
DisaggController`. In the port the two "groups" share one process (one
rank of the serving mesh), its device and ONE parameter tree (the JAX
package places a copy per group); each worker still owns its own pool and
allocator, and the link cost is simulated in the transfer engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import ContinuousProgram
from repro_torch.serve.kv_transfer import KVTransferEngine
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import (DecodeScheduler, PrefillScheduler,
                                         Request)


@dataclasses.dataclass
class MigrationTicket:
    """A finished prefill awaiting migration to the decode group.

    Owns the request's prefill-pool pages (allocator EXPORTED state) until
    the transfer lands; ships only page ids + the tiny batch-1 recurrent
    carry + the final-position logits — never a contiguous KV cache."""

    request: Request
    tokens: List[int]        # prompt + replayed resume tokens
    n_done: int              # tokens generated before this prefill (resume)
    src_pages: List[int]     # prefill-pool page ids, logical order
    prec: object             # batch-1 recurrent carry (tensor tree)
    last_logits: torch.Tensor  # [1, V] f32 final-position logits


def _sample_args(req: Request, n_done: int) -> tuple:
    sp = req.sampling
    return (np.asarray([req.rid], np.int32), np.asarray([n_done], np.int32),
            np.asarray([sp.temperature], np.float32),
            np.asarray([sp.top_k], np.int32),
            np.asarray([sp.top_p], np.float32))


class PrefillWorker:
    """Chunked paged prefill on the attention-strong group. ``params`` is
    the tree the model runs on (``stack.compute_params``)."""

    def __init__(self, program: ContinuousProgram, params,
                 sched: PrefillScheduler):
        if sched.allocator is None:
            raise ValueError("prefill scheduler needs the prefill pool's "
                             "allocator")
        self.p = program
        self.params = params
        self.sched = sched
        self.track = "prefill"  # tracer track (§15)
        sched.track = self.track
        # The detached prefill state (the batch-1 program's; this rank's
        # blocks on a mesh): pools sized by the PREFILL group's memory
        # budget, batch-1 recurrent skeleton — no decode-engine slot
        # geometry anywhere.
        self.state = program.init_state()
        self.prec = None  # batch-1 recurrent carry of the mid-flight prompt

    @property
    def allocator(self):
        return self.sched.allocator

    def step(self) -> List[MigrationTicket]:
        """Spend up to ``token_budget`` prefill tokens on the FIFO queue;
        returns tickets for prompts now fully cached in the prefill pool.
        The batch-1 stream is the landing site (slot hooks are trivial);
        page admission against the prefill allocator is the real gate."""
        tickets = []
        tr = obs_trace.TRACER
        budget = self.sched.token_budget
        while budget > 0:
            chunk = self.sched.plan(budget, lambda: True, lambda: 0)
            if chunk is None:
                break
            req = chunk.request
            with tr.span(self.track, "prefill", rid=req.rid,
                         start=chunk.start, length=chunk.length):
                if chunk.first:
                    tr.flow(self.track, "prefill", req.rid)
                toks = np.asarray(
                    chunk.tokens[chunk.start:chunk.start + chunk.length],
                    np.int32)[None, :]
                if chunk.start == 0:  # fresh (or resumed) -> fresh carry
                    self.prec = self.p.init_prec()
                ptrow = self.allocator.table(req.rid,
                                             self.p.max_pages)[None, :]
                self.state, self.prec, logits = self.p.prefill_step(
                    self.params, self.state, self.prec, toks, chunk.start,
                    ptrow)
            budget -= chunk.length
            if self.sched.finish_chunk(chunk):
                ticket = MigrationTicket(
                    request=req, tokens=list(chunk.tokens),
                    n_done=chunk.n_done,
                    src_pages=self.allocator.export_pages(req.rid),
                    prec=self.prec, last_logits=logits)
                tickets.append(ticket)
                tr.instant(self.track, "ticket", rid=req.rid,
                           pages=len(ticket.src_pages))
                self.prec = None
        return tickets


class DecodeWorker:
    """Continuous-batching decode on the expert group. ``params`` is the
    tree the model runs on (``stack.compute_params``)."""

    def __init__(self, program: ContinuousProgram, params,
                 sched: DecodeScheduler, *,
                 metrics: Optional[ServeMetrics] = None,
                 on_token: Optional[Callable] = None,
                 record_logits: bool = False):
        alloc = sched.allocator
        if alloc is None:
            raise ValueError("decode scheduler needs the decode pool's "
                             "allocator")
        if alloc.page_size != program.page_size \
                or alloc.n_pages != program.n_pages \
                or alloc.max_pages_per_seq < program.max_pages:
            raise ValueError("allocator geometry disagrees with the program")
        self.p = program
        self.params = params
        self.sched = sched
        self.track = "decode"  # tracer track (§15)
        sched.track = self.track
        self.metrics = metrics or ServeMetrics()
        self.on_token = on_token
        self.record_logits = record_logits
        self.logits: Dict[int, List[np.ndarray]] = {}
        B = program.n_slots
        self.state = program.init_state()
        # Host mirrors of the per-slot decode inputs (same layout as the
        # unified ContinuousBatchingEngine).
        self._tok = np.zeros((B,), np.int32)
        self._pos = np.full((B,), -1, np.int32)
        self._active = np.zeros((B,), bool)
        self._rid = np.zeros((B,), np.int32)
        self._ngen = np.zeros((B,), np.int32)
        self._temp = np.zeros((B,), np.float32)
        self._topk = np.zeros((B,), np.int32)
        self._topp = np.ones((B,), np.float32)
        self._ptab = np.full((B, program.max_pages), -1, np.int32)
        self.page_peak = 0
        # EP decode: the controller attaches a RoutingEMA here (§11)
        self.routing_ema = None

    @property
    def allocator(self):
        return self.sched.allocator

    # -- migration (the inbound half of the handoff) ------------------------

    def try_admit(self, ticket: MigrationTicket,
                  src_worker: PrefillWorker,
                  transfer: KVTransferEngine, tick: int, *,
                  src_name: str = "*", dst_name: str = "*") -> bool:
        """Land a migration ticket: lease pages in the decode pool, ship
        the KV pages, commit the lease, insert the recurrent carry, rewrite
        the page table, and sample the request's next token from the
        shipped logits. False (nothing changed) when no free slot or not
        enough pages. Transactional (DESIGN.md §13): the destination pages
        stay under an in-flight lease until the transfer lands, so a
        failed/aborted transfer rolls back here — lease returned, slot
        released, source pages still EXPORTED for the caller's
        ``abort_export`` — and the exception propagates."""
        req = ticket.request
        if not self.sched.has_free():
            return False
        dst = self.allocator.begin_import(req.rid, len(ticket.tokens))
        if dst is None:
            return False
        slot = self.sched.claim_slot()
        try:
            with obs_trace.TRACER.span(self.track, "admit", rid=req.rid,
                                       pages=len(dst)):
                self.state = transfer.transfer(
                    src_worker.state, self.state, ticket.src_pages, dst,
                    dst_n_pages=self.p.n_pages,
                    src_name=src_name, dst_name=dst_name, rid=req.rid,
                    src_pool=src_worker.p.pool, dst_pool=self.p.pool)
        except Exception as e:
            # The exception carries the destination tree (the JAX
            # package's donated scatter makes it the only live one; here
            # it is this worker's own). The partial writes only touched
            # pages under the lease we're about to abort.
            live = getattr(e, "dst_state", None)
            if live is not None:
                self.state = live
            self.allocator.abort_import(req.rid)
            self.sched.release_slot(slot)
            raise
        self.allocator.commit_import(req.rid)
        src_worker.allocator.release_exported(req.rid)
        self.state = self.p.insert_step(self.state, ticket.prec, slot)
        first = self.p.sample_step(ticket.last_logits,
                                   *_sample_args(req, ticket.n_done))
        self._ptab[slot] = self.allocator.table(req.rid, self.p.max_pages)
        return self._activate(req, slot, ticket.tokens, ticket.n_done,
                              int(first[0]), ticket.last_logits, tick)

    def _activate(self, req: Request, slot: int, tokens: List[int],
                  n_done: int, first: int, last_logits, tick: int) -> bool:
        """Hand the admitted request to the decode scheduler and fill its
        slot's host mirrors. Always True (the admission happened)."""
        if self.record_logits:
            row = last_logits[0].cpu().numpy()
            if n_done == 0:
                self.logits[req.rid] = [row]
            else:
                self.logits[req.rid].append(row)
        self.metrics.on_token(req.rid, tick)
        finished = self.sched.activate(req, slot, tokens, n_done, first)
        if self.on_token:
            self.on_token(req.rid, first, finished)
        if finished:
            self.metrics.on_finish(req.rid, tick)
            self._ptab[slot] = -1
            return True
        sp = req.sampling
        self._tok[slot] = first
        self._pos[slot] = len(tokens)
        self._active[slot] = True
        self._rid[slot] = req.rid
        self._ngen[slot] = n_done + 1
        self._temp[slot] = sp.temperature
        self._topk[slot] = sp.top_k
        self._topp[slot] = sp.top_p
        return True

    # -- prefix-cache full hit (DESIGN.md §14) ------------------------------

    def try_admit_cached(self, req: Request, tokens: List[int],
                         n_done: int, tick: int) -> bool:
        """Admit a request whose prompt is a FULL prefix-cache hit straight
        into a decode slot — zero KV transfer: the decode pool already
        holds every line but the last, so a 1-token prefill at offset
        ``len(tokens) - 1`` on THIS program (into a COW-forked tail page if
        the cached one is shared) completes the KV and yields the same
        final-position logits the prefill worker would have shipped —
        token-exact by the (seed, rid, n) sampling contract.
        Opportunistic: False (nothing changed) when there is no hit, no
        slot, or no pages — the request stays queued for the ordinary
        prefill path."""
        index = self.sched.prefix_index
        if index is None or not self.sched.has_free() or len(tokens) < 2:
            return False
        pages, n_cached = index.lookup(tokens)
        if n_cached < len(tokens) - 1:
            return False
        alloc = self.allocator
        if not alloc.share_pages(req.rid, len(tokens), pages):
            return False
        last = len(tokens) - 1
        pslot = last // alloc.page_size
        table = alloc.tables[req.rid]
        if alloc.is_shared(table[pslot]):
            try:
                old, new = alloc.cow_fork(req.rid, pslot)
            except MemoryError:
                alloc.free(req.rid)  # fall back to the prefill path
                return False
            self.state = self.p.fork_step(self.state, [old], [new])
        slot = self.sched.claim_slot()
        ptrow = alloc.table(req.rid, self.p.max_pages)[None, :]
        toks = np.asarray([tokens[last]], np.int32)[None, :]
        with obs_trace.TRACER.span(self.track, "cached-admit", rid=req.rid,
                                   cached=n_cached):
            prec = self.p.init_prec()
            self.state, prec, logits = self.p.prefill_step(
                self.params, self.state, prec, toks, last, ptrow)
            first = self.p.sample_step(logits, *_sample_args(req, n_done))
            self.state = self.p.insert_step(self.state, prec, slot)
        self._ptab[slot] = alloc.table(req.rid, self.p.max_pages)
        return self._activate(req, slot, tokens, n_done, int(first[0]),
                              logits, tick)

    # -- decode tick --------------------------------------------------------

    def ensure_pages(self) -> List[tuple]:
        """Claim a decode-pool page for every live slot whose next write
        position crossed its allocated frontier; on pool OOM preempt the
        newest running request. Returns the preempted (request, generated)
        pairs — the controller requeues them for re-prefill."""
        alloc = self.allocator
        preempted = []
        order = sorted((int(s) for s in np.nonzero(self._active)[0]),
                       key=lambda s: self.sched.running[s].seq)
        for slot in order:
            if not self._active[slot]:
                continue  # evicted by an earlier slot's OOM relief
            rid = int(self._rid[slot])
            while not alloc.covers(rid, int(self._pos[slot])):
                if alloc.extend(rid):
                    self._ptab[slot] = alloc.table(rid, self.p.max_pages)
                    continue
                out = self.sched.pop_newest()
                if out is None:
                    raise RuntimeError("pool OOM with nothing to preempt")
                victim, request, generated = out
                self._clear_slot(victim)
                preempted.append((request, generated))
                if victim == slot:
                    break  # this slot itself was evicted; it will resume
            if self._active[slot]:
                self._cow_guard(slot, rid, preempted)
        return preempted

    def _cow_guard(self, slot: int, rid: int, preempted: List[tuple]) -> None:
        """Fork the page this slot is about to write if it is still shared
        (decode half of fork-on-divergence, §14). Pool OOM preempts the
        newest running request for the copy target, appending to the
        caller's ``preempted`` list."""
        alloc = self.allocator
        table = alloc.tables.get(rid)
        pslot = int(self._pos[slot]) // alloc.page_size
        if not table or pslot >= len(table) \
                or not alloc.is_shared(table[pslot]):
            return
        while True:
            try:
                old, new = alloc.cow_fork(rid, pslot)
                break
            except MemoryError:
                out = self.sched.pop_newest()
                if out is None:
                    raise RuntimeError("COW OOM with nothing to "
                                       "preempt") from None
                victim, request, generated = out
                self._clear_slot(victim)
                preempted.append((request, generated))
                if victim == slot:
                    return  # the writer itself was evicted; it resumes
        self.state = self.p.fork_step(self.state, [old], [new])
        self._ptab[slot] = alloc.table(rid, self.p.max_pages)

    def decode_once(self, tick: int) -> None:
        """One batched decode step over all live slots."""
        with obs_trace.TRACER.span(self.track, "decode",
                                   n_active=int(self._active.sum())):
            out = self.p.decode_step(
                self.params, self.state, self._tok[:, None], self._pos,
                self._ptab, self._active, self._rid, self._ngen,
                self._temp, self._topk, self._topp)
        if self.p.ep is not None:
            self.state, nxt, logits, counts = out
            self._on_ep_counts(counts.cpu().numpy())
        else:
            self.state, nxt, logits = out
        nxt = nxt.cpu().numpy()
        if self.record_logits:
            logits = logits.cpu().numpy()
        for slot in np.nonzero(self._active)[0]:
            slot = int(slot)
            tok = int(nxt[slot])
            rid = int(self._rid[slot])
            if self.record_logits:
                self.logits[rid].append(logits[slot])
            self.metrics.on_token(rid, tick)
            finished = self.sched.note_token(slot, tok)
            if self.on_token:
                self.on_token(rid, tok, finished)
            if finished:
                self.metrics.on_finish(rid, tick)
                self._clear_slot(slot)
            else:
                self._tok[slot] = tok
                self._pos[slot] += 1
                self._ngen[slot] += 1
        self.page_peak = max(self.page_peak, self.allocator.pages_in_use)

    def _on_ep_counts(self, counts) -> None:
        """Routing-histogram hook (EP decode program, DESIGN.md §11):
        the controller attaches a RoutingEMA here when EP is enabled."""
        if self.routing_ema is not None:
            self.routing_ema.update(counts)

    def _clear_slot(self, slot: int) -> None:
        self._active[slot] = False
        self._pos[slot] = -1
        self._tok[slot] = 0
        self._ngen[slot] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 1.0
        self._ptab[slot] = -1

    def any_active(self) -> bool:
        return bool(self._active.any())
