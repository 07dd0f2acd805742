"""Paged KV-cache block allocator (DESIGN.md §9, §14).

vLLM-style block-granular cache management, host-side only (mirrors the
scheduler: the allocator decides WHICH physical pages a request owns; the
engine's jitted steps consume the decision as `[B, max_pages]` page-table
arrays). The device-side pool is `[n_pages, page_size, ...]` per attention
layer; a page id indexes the same physical slot in every layer's pool.

Contracts:

* every in-use physical page carries a REFCOUNT (DESIGN.md §14): one per
  live-table occurrence, one per in-transit export, one per in-flight
  import lease, one per prefix-index PIN. ``check()`` asserts exact
  refcount conservation — the PR 4 "owned by at most one request"
  invariant is the refcount-1 special case and still holds verbatim for
  any run that never shares;
* freeing is a **page-table reset** — a page returns to the free list
  when its LAST reference drops, and the request's table entry is
  dropped with no device traffic. Stale KV lines in recycled pages are
  unreachable because the paged attention paths compute key positions
  structurally from the page-table slot (line ``j`` of table slot ``p``
  is position ``p * page_size + j``) and mask everything beyond the
  owner's causal frontier (DESIGN.md §9.2). The same structural-position
  argument is what makes SHARING sound: a page mounted at the same
  logical slot of two tables reads identically for both owners;
* ``share_pages`` builds a table whose leading slots alias
  already-resident pages (prefix-cache hit) and only draws fresh pages
  for the tail; ``cow_fork`` replaces one shared slot with a private
  copy-target page *before* the owner's first write into it
  (copy-on-write: writers never mutate a page with refcount > 1 — the
  engine copies the page's device lines old -> new after forking);
* allocation is all-or-nothing: ``allocate``/``share_pages``/``extend``
  either hand over every requested page or change nothing. When the
  free list runs short the allocator first consults the optional
  ``reclaim`` hook (the prefix index's LRU eviction), which may unpin
  cold cached pages back onto the free list;
* ownership transfer (disaggregated serving, DESIGN.md §10) is a
  three-state machine per request: live -> exported (pages owned by the
  in-flight KV transfer, reachable by neither side's engines) ->
  released (back on the free list once the destination pool holds the
  data). Only EXCLUSIVELY owned pages (refcount 1) may be exported —
  shared pages stay put, which is why prefix-hit requests skip the
  transfer entirely;
* the DESTINATION half of a handoff holds its claimed pages under an
  in-flight LEASE (``begin_import`` -> ``commit_import`` /
  ``abort_import``, DESIGN.md §13): leased pages are off the free list
  but not yet in any live table, so a transfer that dies mid-flight can
  neither leak a page (abort returns the whole lease) nor double-own one
  (``check()`` counts leases too). ``import_pages`` is the one-shot
  begin+commit wrapper for transfers with no failure path.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache lines."""
    return -(-max(n_tokens, 0) // page_size)


class BlockAllocator:
    """Free-list allocator over ``n_pages`` fixed-size physical pages."""

    def __init__(self, n_pages: int, page_size: int, max_pages_per_seq: int):
        assert n_pages >= 1 and page_size >= 1 and max_pages_per_seq >= 1
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self._free: List[int] = list(range(n_pages - 1, -1, -1))  # pop -> 0
        self.tables: Dict[int, List[int]] = {}  # rid -> owned page ids
        self.exported: Dict[int, List[int]] = {}  # rid -> in-transit pages
        self.leases: Dict[int, List[int]] = {}  # rid -> inbound in-flight
        self.ref: Dict[int, int] = {}  # page -> total refcount (in-use only)
        self.pins: Dict[int, int] = {}  # page -> prefix-index pin count
        # Optional LRU-eviction hook (the prefix index): called with the
        # page shortfall when the free list cannot cover a request, may
        # return pages to the free list by unpinning cold cache entries.
        self.reclaim: Optional[Callable[[int], int]] = None
        self.n_fresh_allocs = 0  # pages drawn from the free list (bench)
        self.n_shared_allocs = 0  # table slots served by sharing (bench)
        self.n_cow_forks = 0  # cow_fork count (bench / tests)

    # -- capacity -----------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.page_size)

    def fits_pool(self, n_tokens: int) -> bool:
        """Whether a request of ``n_tokens`` total lines can EVER be served
        (worst-case page need within the whole pool and the per-seq table).
        Checked at submit so preemption can always make progress down to a
        single live request — prefix-index pins do not break this because
        ``reclaim`` can evict every pin whose page is not also live."""
        need = self.pages_for(n_tokens)
        return need <= min(self.n_pages, self.max_pages_per_seq)

    # -- refcount internals -------------------------------------------------

    def _incref(self, page: int) -> None:
        self.ref[page] = self.ref.get(page, 0) + 1

    def _decref(self, page: int) -> None:
        n = self.ref[page] - 1
        if n:
            self.ref[page] = n
        else:
            del self.ref[page]
            self._free.append(page)

    def _take_free(self, need: int) -> Optional[List[int]]:
        """Pop ``need`` fresh pages, consulting the ``reclaim`` hook on
        shortfall. All-or-nothing: None when the pool cannot cover it."""
        if need > len(self._free) and self.reclaim is not None:
            self.reclaim(need - len(self._free))
        if need > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(need)]
        for p in pages:
            self._incref(p)
        self.n_fresh_allocs += len(pages)
        return pages

    def is_shared(self, page: int) -> bool:
        """True when writes to ``page`` must COW-fork first (refcount > 1:
        some other table, export, lease, or index pin also holds it)."""
        return self.ref.get(page, 0) > 1

    # -- allocation ---------------------------------------------------------

    def allocate(self, rid: int, n_tokens: int) -> bool:
        """Fresh table for ``rid`` covering ``n_tokens`` lines.

        All-or-nothing: returns False (and allocates nothing) when the free
        list cannot cover the request. ``rid`` must not already own pages.
        """
        return self.share_pages(rid, n_tokens, ())

    def share_pages(self, rid: int, n_tokens: int,
                    shared: "List[int] | tuple") -> bool:
        """Table for ``rid`` covering ``n_tokens`` lines whose leading
        slots ALIAS the already-resident ``shared`` pages (prefix-cache
        hit, DESIGN.md §14); only the tail draws fresh pages. Shared pages
        are increfed, never copied — a writer COW-forks before touching
        one. All-or-nothing like ``allocate``."""
        assert rid not in self.tables, f"rid {rid} already owns pages"
        need = self.pages_for(n_tokens)
        shared = list(shared)[:need]
        if need > self.max_pages_per_seq:
            return False
        for p in shared:
            assert p in self.ref, f"shared page {p} is not resident"
        # Hold our reference BEFORE drawing fresh pages: the reclaim hook
        # may evict index pins mid-draw, and these pages must survive it.
        for p in shared:
            self._incref(p)
        fresh = self._take_free(need - len(shared))
        if fresh is None:
            for p in shared:
                self._decref(p)
            return False
        self.n_shared_allocs += len(shared)
        self.tables[rid] = shared + fresh
        return True

    def extend(self, rid: int, n_new: int = 1) -> bool:
        """Append ``n_new`` pages to ``rid``'s table (decode growth)."""
        table = self.tables[rid]
        if len(table) + n_new > self.max_pages_per_seq:
            return False
        fresh = self._take_free(n_new)
        if fresh is None:
            return False
        table.extend(fresh)
        return True

    def cow_fork(self, rid: int, slot: int) -> "tuple[int, int]":
        """Replace the SHARED page at table slot ``slot`` of ``rid`` with a
        private fresh page (fork-on-write, DESIGN.md §14). Host-side only:
        the caller must copy the device lines ``old -> new`` (the engine's
        ``fork_step``) before any write lands. Returns ``(old, new)``.
        Raises MemoryError when no page can be reclaimed for the copy."""
        table = self.tables[rid]
        old = table[slot]
        assert self.is_shared(old), \
            f"cow_fork on exclusively-owned page {old} (slot {slot})"
        fresh = self._take_free(1)
        if fresh is None:
            raise MemoryError("cow_fork: pool exhausted")
        table[slot] = fresh[0]
        self._decref(old)
        self.n_cow_forks += 1
        return old, fresh[0]

    def free(self, rid: int) -> None:
        """Drop ``rid``'s table: each page loses one reference and returns
        to the free list only when nobody else (table/export/lease/pin)
        still holds it (copy-free recycle: the page-table reset IS the
        recycle)."""
        for p in self.tables.pop(rid, ()):
            self._decref(p)

    # -- prefix-index pins (DESIGN.md §14) ----------------------------------

    def pin(self, page: int) -> None:
        """Add a prefix-index reference to a resident page: the page
        survives its owner's ``free`` so future requests can share it."""
        assert page in self.ref, f"pin of non-resident page {page}"
        self.pins[page] = self.pins.get(page, 0) + 1
        self._incref(page)

    def unpin(self, page: int) -> None:
        """Drop one index reference (LRU eviction); the page is freed when
        this was the last reference of any kind."""
        n = self.pins[page] - 1
        if n:
            self.pins[page] = n
        else:
            del self.pins[page]
        self._decref(page)

    # -- ownership transfer (disaggregated handoff, DESIGN.md §10) ----------

    def export_pages(self, rid: int) -> List[int]:
        """Detach ``rid``'s pages from the live table for an outbound KV
        transfer. The pages leave the table but do NOT return to the free
        list: they are owned by the in-flight transfer (readable source
        data, unreachable by any engine-side page table) until
        ``release_exported`` lands them back. Only exclusively-owned
        pages may travel — a shared page's other owners would be left
        pointing at a recycled slot. Returns the page ids in logical
        (page-slot) order."""
        assert rid not in self.exported, f"rid {rid} already exporting"
        pages = self.tables[rid]
        for p in pages:
            assert self.ref[p] == 1, \
                f"export of shared page {p} (ref {self.ref[p]})"
        del self.tables[rid]
        self.exported[rid] = pages
        return list(pages)

    def release_exported(self, rid: int) -> None:
        """Finish an export: the destination pool holds the data, so the
        source pages recycle to the free list (a list move — no device
        traffic, like ``free``)."""
        for p in self.exported.pop(rid):
            self._decref(p)

    def abort_export(self, rid: int) -> None:
        """Undo ``export_pages`` (failed transfer): the pages return to the
        live table untouched — the source pool still holds valid KV."""
        assert rid not in self.tables, f"rid {rid} re-allocated mid-export"
        self.tables[rid] = self.exported.pop(rid)

    def begin_import(self, rid: int, n_tokens: int) -> Optional[List[int]]:
        """Destination half of the handoff, transactional (DESIGN.md §13):
        claim pages covering ``n_tokens`` lines under an in-flight LEASE.
        Leased pages are off the free list but in no live table — the
        transfer engine scatters into them while they are unreachable by
        any engine-side page table. ``commit_import`` lands them in the
        live table; ``abort_import`` (transfer failed / destination
        crashed mid-flight) returns the whole lease to the free list, so
        a dead transfer can neither leak nor double-own a page.
        All-or-nothing like ``allocate``; returns the leased page ids in
        logical order, or None when the pool cannot cover the request."""
        assert rid not in self.tables, f"rid {rid} already owns pages"
        assert rid not in self.leases, f"rid {rid} already importing"
        need = self.pages_for(n_tokens)
        if need > self.max_pages_per_seq:
            return None
        pages = self._take_free(need)
        if pages is None:
            return None
        self.leases[rid] = pages
        return list(pages)

    def commit_import(self, rid: int) -> None:
        """Transfer landed: promote the lease to the live table."""
        assert rid not in self.tables, f"rid {rid} re-allocated mid-import"
        self.tables[rid] = self.leases.pop(rid)

    def abort_import(self, rid: int) -> None:
        """Transfer failed: the leased pages hold garbage no table points
        at — return them to the free list untouched."""
        for p in self.leases.pop(rid):
            self._decref(p)

    def import_pages(self, rid: int, n_tokens: int) -> Optional[List[int]]:
        """One-shot begin+commit import for transfers with no failure
        path (returns the page ids now in ``rid``'s live table)."""
        if self.begin_import(rid, n_tokens) is None:
            return None
        self.commit_import(rid)
        return list(self.tables[rid])

    # -- introspection ------------------------------------------------------

    def covers(self, rid: int, line: int) -> bool:
        """Whether cache line ``line`` falls inside ``rid``'s owned pages."""
        return line < len(self.tables.get(rid, ())) * self.page_size

    def n_lines(self, rid: int) -> int:
        return len(self.tables.get(rid, ())) * self.page_size

    def table(self, rid: int, pad_to: int | None = None) -> np.ndarray:
        """``rid``'s page table as int32, -1-padded to ``pad_to`` slots."""
        pages = self.tables.get(rid, [])
        pad_to = self.max_pages_per_seq if pad_to is None else pad_to
        out = np.full((pad_to,), -1, np.int32)
        out[:len(pages)] = pages
        return out

    def check(self) -> None:
        """Assert refcount conservation (DESIGN.md §14): every page's
        refcount equals its occurrences across live tables, in-transit
        exports, in-flight import leases, and index pins; pages with no
        references sit on the free list exactly once; nothing leaks and
        nothing is double-owned. For runs that never share this reduces
        to the PR 4 exactly-once invariant."""
        want: Dict[int, int] = {}
        for pages in self.tables.values():
            for p in pages:
                want[p] = want.get(p, 0) + 1
        for pages in self.exported.values():
            for p in pages:
                want[p] = want.get(p, 0) + 1
        for pages in self.leases.values():
            for p in pages:
                want[p] = want.get(p, 0) + 1
        for p, n in self.pins.items():
            want[p] = want.get(p, 0) + n
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "page owned twice (free)"
        assert len(self._free) + len(self.ref) == self.n_pages, \
            f"page leak: {len(self._free) + len(self.ref)} tracked " \
            f"of {self.n_pages}"
        for p, n in self.ref.items():
            assert p not in free_set, f"page {p} both free and owned twice"
            assert want.get(p, 0) == n, \
                f"page {p} refcount {n} != {want.get(p, 0)} referenced " \
                f"(leak or double-own)"
        for p in want:
            assert p in self.ref, f"page {p} referenced but leak-untracked"
