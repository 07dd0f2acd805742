"""Continuous-batching request scheduling (DESIGN.md §7.1/§7.3, §9.4, §10;
a copy of the JAX package's ``serve/scheduler.py``).

Host-side bookkeeping only — no torch. Scheduling is split into two policies
so the unified engine and the disaggregated prefill/decode deployment
share one implementation:

* :class:`PrefillScheduler` — the prefill-side policy: FIFO queue, submit
  validation, chunk planning under a per-tick token budget, and
  page-budget admission against ITS pool's allocator. Where the admitted
  request lands (a decode slot in the unified engine, the single batch-1
  prefill stream in a disaggregated PrefillWorker) is the caller's
  business, injected through the ``has_slot`` / ``claim_slot`` hooks.
* :class:`DecodeScheduler` — the decode-side policy: slot lifecycle
  (activate -> note_token -> finish/recycle), per-request results, and
  newest-first preemption for pool-OOM relief. Freeing a finished or
  preempted request releases its pages in the DECODE-side allocator.
* :class:`Scheduler` — the unified engine's view: both policies over ONE
  pool and ONE slot set (prefill admission claims a decode slot up
  front). Its public surface is unchanged from the pre-split scheduler.

Slot lifecycle: queued -> prefilling (chunks of <= prefill_chunk tokens
into the batch-1 prefill cache) -> active (inserted into a free slot of
the batched decode state) -> finished (EOS or length limit) -> slot freed
and recycled. An insert overwrites EVERY decode-state leaf of the slot
(KV cache, cache positions, recurrent states), which is why recycling can
never leak state across requests.

Admission rules:
  * a request must fit its slot: len(prompt) + max_new_tokens <= max_len
    (checked at submit — oversized requests are rejected immediately);
  * at most ``token_budget`` prompt tokens are scheduled per tick, so a
    long prompt is spread over several ticks and decode of live slots
    never stalls for more than one chunk;
  * one request prefills at a time (its chunks are sequential — they
    share the single prefill cache); the queue is FIFO.

Paged mode (``allocator`` set, DESIGN.md §9.4) adds page-budget admission:
the queue head is admitted only when a slot AND enough free pages for its
prompt exist (admission budgets PAGES, not slots x max_len — that is the
whole point of paging); decode growth claims pages one at a time, and when
the pool runs dry the NEWEST running request is preempted: its pages
return to the free list (a page-table reset, no device traffic) and it
re-queues at the queue FRONT with its generated tokens as resume state.
Re-prefilling prompt+generated reproduces its remaining tokens exactly
because sampling keys are ``key(rid, n)`` — schedule-independent (§7.4).

Prefix caching (``prefix_index`` set, DESIGN.md §14) changes admission
from ``allocate`` to ``share_pages``: the longest cached prefix of the
token list mounts as shared leading table slots and prefill SKIPS those
lines entirely — the chunk stream starts at ``skipped`` (capped at
``len(tokens) - 1`` so at least one line always prefills and the first
sampled token keeps coming from prefill logits, schedule-independent as
ever). The decode side registers finished KV runs back into the index.

Fairness (``fair=True``, DESIGN.md §14): admission picks the next
request by per-tenant deficit round-robin (the tenant with the fewest
admissions so far goes first) instead of global FIFO, so one tenant's
burst cannot starve the pool; within a tenant order stays FIFO, and a
preempted request's front-requeue still resumes before anything else.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.obs import trace as obs_trace
from repro_torch.serve.kv_blocks import BlockAllocator
from repro_torch.serve.sampling import GREEDY, SamplingParams


@dataclasses.dataclass
class Request:
    """One generation request."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingParams = GREEDY
    eos_token: Optional[int] = None
    arrival: float = 0.0  # trace time (engine ticks in the simulated clock)
    tenant: int = 0  # fairness domain (multi-tenant admission, §14)


@dataclasses.dataclass
class _QueueEntry:
    """A queued request plus its resume state (non-empty after preemption:
    the tokens it had already generated, replayed as prompt on re-prefill)."""

    request: Request
    resume: List[int] = dataclasses.field(default_factory=list)

    @property
    def tokens(self) -> List[int]:
        return self.request.prompt + self.resume


@dataclasses.dataclass
class PrefillChunk:
    """One scheduled slice of a request's (prompt + resume) token list."""

    request: Request
    slot: int
    start: int
    length: int
    tokens: List[int] = None  # full prompt (+ resumed generations)
    n_done: int = 0           # tokens already generated before this prefill
    skipped: int = 0          # leading lines served by the prefix cache

    def __post_init__(self):
        if self.tokens is None:
            self.tokens = self.request.prompt

    @property
    def final(self) -> bool:
        return self.start + self.length >= len(self.tokens)

    @property
    def first(self) -> bool:
        """Whether this is the request's first chunk this prefill pass
        (``start`` sits at the cache-skip point, not at 0 — §14)."""
        return self.start == self.skipped


@dataclasses.dataclass
class _Running:
    request: Request
    n_generated: int = 0
    seq: int = 0  # admission order (monotonic; newest = preemption victim)


class PrefillScheduler:
    """Prefill-side policy: queue, chunking, page-budget admission."""

    def __init__(self, max_len: int, *, prefill_chunk: int = 64,
                 token_budget: Optional[int] = None,
                 allocator: Optional[BlockAllocator] = None,
                 prefix_index=None, fair: bool = False):
        assert prefill_chunk >= 1
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.token_budget = token_budget or prefill_chunk
        self.allocator = allocator
        self.prefix_index = prefix_index
        self.fair = fair
        self.queue: Deque[_QueueEntry] = collections.deque()
        self._prefilling = None  # (entry, slot, next_start, skipped) | None
        self.n_rejected = 0
        self.n_prefix_hits = 0
        self.n_tokens_skipped = 0
        self._admitted: Dict[int, int] = {}  # tenant -> admissions (fair)
        self.track = "serve"  # tracer track (§15); factories override
        # Why the last plan() returned None: "empty" (no queued work),
        # "no-slot" (landing site busy), "pages" (pool cannot back the
        # head), or None after a successful plan. Engines read this to
        # bucket idle ticks (pool-OOM vs queue-starved) without the
        # tracer ever influencing scheduling.
        self.wait_reason: Optional[str] = None

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) < 1 or req.max_new_tokens < 1:
            self.n_rejected += 1
            raise ValueError(f"request {req.rid}: empty prompt or zero budget")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            self.n_rejected += 1
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} exceeds max_len {self.max_len}")
        if self.allocator is not None and not self.allocator.fits_pool(
                len(req.prompt) + req.max_new_tokens):
            # Worst-case page need exceeds the whole pool: preemption could
            # never clear room, so reject up front (keeps OOM-preemption
            # guaranteed to make progress down to one live request).
            self.n_rejected += 1
            raise ValueError(
                f"request {req.rid}: needs more pages than the pool holds")
        self.queue.append(_QueueEntry(req))

    def requeue_front(self, request: Request, resume: List[int]) -> None:
        """Front-of-queue requeue after preemption: ``resume`` carries the
        tokens already generated, replayed as prompt on re-prefill."""
        self.queue.appendleft(_QueueEntry(request, resume=list(resume)))

    # -- prefill planning ---------------------------------------------------

    def plan(self, budget: int, has_slot: Callable[[], bool],
             claim_slot: Callable[[], int]) -> Optional[PrefillChunk]:
        """Next prompt chunk to run, spending at most ``budget`` tokens.

        Admits the queue head when nothing is mid-prefill: ``has_slot`` /
        ``claim_slot`` are the landing-site hooks (a decode slot in the
        unified engine, the batch-1 stream in a disagg PrefillWorker); in
        paged mode the head additionally claims pages for its full token
        list from THIS side's allocator — all-or-nothing, so a
        half-admitted request never wedges the pool. Returns None when
        there is no admissible work."""
        if budget <= 0:
            return None
        if self._prefilling is None:
            if not self.queue:
                self.wait_reason = "empty"
                return None
            if not has_slot():
                self.wait_reason = "no-slot"
                return None
            idx = self._select()
            entry = self.queue[idx]
            skipped, shared = 0, ()
            if self.allocator is not None:
                if self.prefix_index is not None:
                    shared, n_cached = self.prefix_index.lookup(entry.tokens)
                    # >= 1 line always prefills so the first sampled token
                    # keeps coming from prefill logits (§14).
                    n_cached = min(n_cached, len(entry.tokens) - 1)
                    if n_cached > 0:
                        skipped = n_cached
                    else:
                        shared = ()
                if not self.allocator.share_pages(
                        entry.request.rid, len(entry.tokens), shared):
                    self.wait_reason = "pages"
                    return None  # wait for pages (freed on finish/migration)
            del self.queue[idx]
            if skipped:
                self.n_prefix_hits += 1
                self.n_tokens_skipped += skipped
                obs_trace.TRACER.instant(
                    self.track, "prefix-skip", rid=entry.request.rid,
                    skipped=skipped)
            tenant = entry.request.tenant
            self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
            self._prefilling = (entry, claim_slot(), skipped, skipped)
            obs_trace.TRACER.flow(
                self.track, "admitted", entry.request.rid,
                tokens=len(entry.tokens), skipped=skipped)
        self.wait_reason = None
        entry, slot, start, skipped = self._prefilling
        length = min(self.prefill_chunk, len(entry.tokens) - start, budget)
        if length <= 0:
            return None
        return PrefillChunk(request=entry.request, slot=slot, start=start,
                            length=length, tokens=entry.tokens,
                            n_done=len(entry.resume), skipped=skipped)

    def _select(self) -> int:
        """Queue index to admit next. FIFO by default; with ``fair`` the
        tenant with the fewest admissions so far goes first (deficit
        round-robin — a flooding tenant cannot starve the rest). A
        preempted request requeued at the front always resumes first."""
        if not self.fair or self.queue[0].resume:
            return 0
        tenants: List[int] = []
        for e in self.queue:
            if e.request.tenant not in tenants:
                tenants.append(e.request.tenant)
        pick = min(tenants, key=lambda t: self._admitted.get(t, 0))
        for i, e in enumerate(self.queue):
            if e.request.tenant == pick:
                return i
        raise AssertionError("unreachable: tenant vanished from queue")

    def finish_chunk(self, chunk: PrefillChunk) -> bool:
        """Record a completed chunk; True when the whole prompt is cached."""
        entry, slot, start, skipped = self._prefilling
        assert entry.request is chunk.request and start == chunk.start
        if chunk.final:
            self._prefilling = None
            return True
        self._prefilling = (entry, slot, start + chunk.length, skipped)
        return False

    # -- introspection ------------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self.queue) + (1 if self._prefilling is not None else 0)

    def has_work(self) -> bool:
        return bool(self.queue) or self._prefilling is not None


class DecodeScheduler:
    """Decode-side policy: slot lifecycle, results, preemption."""

    def __init__(self, n_slots: int, *,
                 allocator: Optional[BlockAllocator] = None,
                 prefix_index=None):
        assert n_slots >= 1
        self.n_slots = n_slots
        self.allocator = allocator
        self.prefix_index = prefix_index
        self.free: List[int] = list(range(n_slots - 1, -1, -1))  # pop -> 0
        self.running: Dict[int, _Running] = {}  # slot -> live request
        self.results: Dict[int, List[int]] = {}  # rid -> generated tokens
        self.n_preempted = 0
        self._admit_seq = 0
        self.track = "serve"  # tracer track (§15); factories override

    # -- slots --------------------------------------------------------------

    def has_free(self) -> bool:
        return bool(self.free)

    def claim_slot(self) -> int:
        return self.free.pop()

    def release_slot(self, slot: int) -> None:
        """Return an UNUSED claimed slot (admission rolled back before
        ``activate`` — e.g. the KV transfer aborted, DESIGN.md §13)."""
        assert slot not in self.running, f"slot {slot} is live"
        self.free.append(slot)

    # -- lifecycle ----------------------------------------------------------

    def activate(self, request: Request, slot: int, tokens: List[int],
                 n_done: int, first_token: int) -> bool:
        """Admit a fully-prefilled request into ``slot`` with its next
        sampled token (the FIRST token for fresh requests; token
        ``n_done`` when resuming after preemption — earlier tokens are
        already in ``results``). ``tokens`` is the prompt + replayed
        resume list the prefill ran over. Returns True if it finished
        immediately — the slot is then freed right away."""
        if n_done == 0:
            self.results[request.rid] = [first_token]
        else:
            assert self.results[request.rid] == list(tokens[
                len(request.prompt):]), "resume tokens diverged from results"
            self.results[request.rid].append(first_token)
        if self.prefix_index is not None and self.allocator is not None:
            # Prompt KV is resident NOW: register the FULL pages so
            # concurrent same-prefix arrivals hit immediately. Full pages
            # are never written again (decode only appends past them);
            # the partial tail waits for finish-time registration.
            ps = self.allocator.page_size
            self.prefix_index.insert(
                tokens, self.allocator.tables.get(request.rid, []),
                n_valid=(len(tokens) // ps) * ps)
        self._admit_seq += 1
        self.running[slot] = _Running(
            request=request, n_generated=n_done + 1, seq=self._admit_seq)
        obs_trace.TRACER.flow(self.track, "decode", request.rid, slot=slot,
                              n_done=n_done)
        return self._maybe_finish(slot, first_token)

    def note_token(self, slot: int, token: int) -> bool:
        """Record one decoded token for a live slot; True when finished."""
        run = self.running[slot]
        run.n_generated += 1
        self.results[run.request.rid].append(token)
        return self._maybe_finish(slot, token)

    def _maybe_finish(self, slot: int, token: int) -> bool:
        run = self.running[slot]
        req = run.request
        done = (req.eos_token is not None and token == req.eos_token) \
            or run.n_generated >= req.max_new_tokens
        if done:
            del self.running[slot]
            self.free.append(slot)
            if self.allocator is not None:
                if self.prefix_index is not None:
                    # The last sampled token was never fed back, so lines
                    # [0, prompt + generated - 1) hold valid KV — register
                    # the whole run incl. the partial tail (multi-turn
                    # replays hit it), THEN free: pinned pages survive the
                    # page-table reset, unpinned ones recycle as before.
                    seq = list(req.prompt) + self.results[req.rid][:-1]
                    self.prefix_index.insert(
                        seq, self.allocator.tables.get(req.rid, []))
                self.allocator.free(req.rid)  # page-table reset = recycle
            obs_trace.TRACER.flow(self.track, "finished", req.rid,
                                  generated=run.n_generated)
        return done

    def pop_newest(self) -> Optional[Tuple[int, Request, List[int]]]:
        """Evict the most recently admitted running request (pool-OOM
        relief): frees its slot and its DECODE-side pages and returns
        (slot, request, generated-so-far) — the caller requeues it on the
        prefill side. None when nothing is running."""
        if not self.running:
            return None
        slot = max(self.running, key=lambda s: self.running[s].seq)
        run = self.running.pop(slot)
        self.free.append(slot)
        rid = run.request.rid
        if self.allocator is not None:
            self.allocator.free(rid)
        self.n_preempted += 1
        obs_trace.TRACER.instant(self.track, "preempt", rid=rid, slot=slot,
                                 generated=run.n_generated)
        return slot, run.request, list(self.results[rid])

    # -- introspection ------------------------------------------------------

    def slot_request(self, slot: int) -> Request:
        return self.running[slot].request

    def slot_generated(self, slot: int) -> int:
        return self.running[slot].n_generated

    @property
    def n_active(self) -> int:
        return len(self.running)


class Scheduler:
    """Unified-engine view: both policies over one pool + one slot set.

    ``allocator`` switches on paged admission (DESIGN.md §9.4): pages are
    claimed for the whole prompt at admission, extended one page at a time
    during decode by the engine, and released on finish/preempt. The same
    allocator backs both policies — prefill writes into the pages decode
    later reads, which is exactly what disaggregation splits apart.
    """

    def __init__(self, n_slots: int, max_len: int, *,
                 prefill_chunk: int = 64, token_budget: Optional[int] = None,
                 allocator: Optional[BlockAllocator] = None,
                 prefix_index=None, fair: bool = False):
        self.n_slots = n_slots
        self.max_len = max_len
        self.allocator = allocator
        self.prefix_index = prefix_index
        self.prefill = PrefillScheduler(max_len, prefill_chunk=prefill_chunk,
                                        token_budget=token_budget,
                                        allocator=allocator,
                                        prefix_index=prefix_index, fair=fair)
        self.decode = DecodeScheduler(n_slots, allocator=allocator,
                                      prefix_index=prefix_index)

    def set_track(self, track: str) -> None:
        """Route both policies' trace events to ``track`` (§15)."""
        self.prefill.track = track
        self.decode.track = track

    # -- delegated state (public surface unchanged by the policy split) -----

    @property
    def prefill_chunk(self) -> int:
        return self.prefill.prefill_chunk

    @property
    def token_budget(self) -> int:
        return self.prefill.token_budget

    @property
    def queue(self) -> Deque[_QueueEntry]:
        return self.prefill.queue

    @property
    def _prefilling(self):
        return self.prefill._prefilling

    @property
    def free(self) -> List[int]:
        return self.decode.free

    @property
    def running(self) -> Dict[int, _Running]:
        return self.decode.running

    @property
    def results(self) -> Dict[int, List[int]]:
        return self.decode.results

    @property
    def n_rejected(self) -> int:
        return self.prefill.n_rejected

    @property
    def n_preempted(self) -> int:
        return self.decode.n_preempted

    # -- lifecycle ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.prefill.submit(req)

    def plan_prefill(self, budget: int) -> Optional[PrefillChunk]:
        return self.prefill.plan(budget, self.decode.has_free,
                                 self.decode.claim_slot)

    def finish_prefill_chunk(self, chunk: PrefillChunk) -> bool:
        return self.prefill.finish_chunk(chunk)

    def activate(self, chunk: PrefillChunk, first_token: int) -> bool:
        return self.decode.activate(chunk.request, chunk.slot, chunk.tokens,
                                    chunk.n_done, first_token)

    def note_token(self, slot: int, token: int) -> bool:
        return self.decode.note_token(slot, token)

    def preempt_newest(self) -> Optional[int]:
        """Evict the newest running request (paged OOM relief, DESIGN.md
        §9.4) and requeue it at the queue FRONT with its generated tokens
        as resume state. Returns the freed slot (engine clears its host
        mirrors), or None when nothing is running."""
        out = self.decode.pop_newest()
        if out is None:
            return None
        slot, request, generated = out
        self.prefill.requeue_front(request, generated)
        return slot

    # -- introspection ------------------------------------------------------

    def slot_request(self, slot: int) -> Request:
        return self.decode.slot_request(slot)

    def slot_generated(self, slot: int) -> int:
        return self.decode.slot_generated(slot)

    @property
    def queue_depth(self) -> int:
        return self.prefill.depth

    @property
    def n_active(self) -> int:
        return self.decode.n_active

    def has_work(self) -> bool:
        return self.prefill.has_work() or bool(self.decode.running)
