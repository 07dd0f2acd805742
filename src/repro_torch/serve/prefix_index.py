"""Token-id prefix index over paged KV — the prefix-cache brain
(DESIGN.md §14; a copy of the JAX package's ``serve/prefix_index.py``).

A radix tree over PAGES: each node is one physical page holding the KV
lines of one ``page_size``-token run, keyed by the token ids of that run
under its parent chain (so the path from the root to a node spells a
prompt prefix, page by page). Interior nodes are always FULL pages; leaf
nodes may be PARTIAL (``n_valid < page_size`` lines written — a finished
request's tail). Lookups walk the tree greedily and may stop mid-page on
a partial match — the divergence point where the engine COW-forks.

Pages referenced by the index are PINNED in the :class:`BlockAllocator`
(one extra refcount), which is what lets them outlive the request that
wrote them. Eviction is leaf-first LRU and only ever UNPINS — the
allocator frees a page when its refcount reaches 0, so a cached page
that some live request still shares survives eviction untouched (the
index merely forgets it). The index registers itself as the allocator's
``reclaim`` hook: an allocation shortfall evicts cold entries before the
allocator refuses, so prefix pins can never wedge admission or
preemption progress.

Soundness leans on the structural-position invariant (§9.2): a page
mounted at the same logical table slot reads as the same positions for
every sharer, so sharing page runs that start at slot 0 is exact by
construction. Registration happens at two points (engine-driven):
prompt full pages at prefill completion, the whole sequence including
the partial tail at request completion (multi-turn replay hits).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.kv_blocks import BlockAllocator


@dataclasses.dataclass
class _Node:
    nid: int
    parent: Optional["_Node"]
    tokens: Tuple[int, ...]  # the token run this page holds (n_valid ids)
    page: int
    n_valid: int  # lines written; == page_size for interior/full nodes
    n_children: int = 0


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixIndex:
    """Prefix -> page-run index with leaf-first LRU eviction.

    ``capacity_pages`` bounds how many pages the index may pin at once
    (None: unbounded — the allocator's reclaim hook is the only bound).
    """

    def __init__(self, allocator: BlockAllocator, *,
                 capacity_pages: Optional[int] = None):
        self.alloc = allocator
        self.page_size = allocator.page_size
        self.capacity_pages = capacity_pages
        self._lru: "OrderedDict[int, _Node]" = OrderedDict()  # cold -> hot
        self._full: Dict[Tuple[int, Tuple[int, ...]], _Node] = {}
        self._children: Dict[int, List[_Node]] = {}  # parent nid -> nodes
        self._next = 1
        self.hits = 0
        self.misses = 0
        self.tokens_served = 0
        self.n_inserted = 0
        self.n_evicted = 0
        allocator.reclaim = self.evict

    # -- introspection ------------------------------------------------------

    @property
    def n_pages(self) -> int:
        return len(self._lru)

    def check(self) -> None:
        """Index-side conservation: every node's page carries at least one
        allocator pin, pin totals match node counts per page, and child
        counters agree with the tree."""
        per_page: Dict[int, int] = {}
        kids: Dict[int, int] = {}
        for node in self._lru.values():
            per_page[node.page] = per_page.get(node.page, 0) + 1
            if node.parent is not None:
                kids[node.parent.nid] = kids.get(node.parent.nid, 0) + 1
        assert per_page == dict(self.alloc.pins), \
            f"index pins {per_page} != allocator pins {self.alloc.pins}"
        for node in self._lru.values():
            assert node.n_children == kids.get(node.nid, 0), \
                f"node {node.nid} child count drift"

    # -- lookup -------------------------------------------------------------

    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: ``(page_run, n_cached)``.

        ``page_run`` are the physical pages covering lines
        ``[0, n_cached)`` when mounted at table slots ``0..len(run)-1``;
        the last page may be valid only up to ``n_cached % page_size``
        lines (mid-page divergence — the sharer must COW-fork it before
        writing). Touches the LRU along the matched path."""
        toks = tuple(tokens)
        ps = self.page_size
        pages: List[int] = []
        path: List[_Node] = []
        n = 0
        parent_id = 0
        while n + ps <= len(toks):
            node = self._full.get((parent_id, toks[n:n + ps]))
            if node is None:
                break
            pages.append(node.page)
            path.append(node)
            n += ps
            parent_id = node.nid
        # Divergence tail: the child (full or partial) sharing the longest
        # common token prefix with what remains still donates those lines.
        rest = toks[n:]
        if rest:
            best, best_m = None, 0
            for cand in self._children.get(parent_id, ()):
                m = min(_common_prefix(cand.tokens, rest), cand.n_valid)
                if m > best_m:
                    best, best_m = cand, m
            if best is not None:
                pages.append(best.page)
                path.append(best)
                n += best_m
        for node in path:
            self._lru.move_to_end(node.nid)
        if n > 0:
            self.hits += 1
            self.tokens_served += n
        elif toks:
            self.misses += 1
        return pages, n

    # -- registration -------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               n_valid: Optional[int] = None) -> int:
        """Register the page run of a request: ``pages`` are its table in
        slot order, holding the KV lines of ``tokens[:n_valid]``. Full
        pages become interior nodes; a trailing remainder becomes a
        partial leaf. Nodes already present are touched, not duplicated
        (first writer wins — the resident page is as good as ours).
        Returns the number of NEW pages pinned."""
        toks = tuple(tokens)
        n_valid = len(toks) if n_valid is None else min(n_valid, len(toks))
        ps = self.page_size
        parent: Optional[_Node] = None
        parent_id = 0
        added = 0
        n_full = n_valid // ps
        for i in range(n_full):
            run = toks[i * ps:(i + 1) * ps]
            node = self._full.get((parent_id, run))
            if node is None:
                if i >= len(pages):
                    break
                node = self._new_node(parent, run, pages[i], ps)
                self._full[(parent_id, run)] = node
                added += 1
            else:
                self._lru.move_to_end(node.nid)
            parent, parent_id = node, node.nid
        rem = n_valid - n_full * ps
        if rem > 0 and n_full < len(pages):
            run = toks[n_full * ps:n_valid]
            # Dedupe against an existing child already covering this run.
            exists = any(
                min(_common_prefix(c.tokens, run), c.n_valid) >= rem
                for c in self._children.get(parent_id, ()))
            if not exists:
                self._new_node(parent, run, pages[n_full], rem)
                added += 1
        self.n_inserted += added
        if self.capacity_pages is not None:
            while len(self._lru) > self.capacity_pages:
                if not self._evict_one():
                    break
        return added

    def _new_node(self, parent: Optional[_Node], tokens: Tuple[int, ...],
                  page: int, n_valid: int) -> _Node:
        node = _Node(self._next, parent, tokens, page, n_valid)
        self._next += 1
        self._lru[node.nid] = node
        self._children.setdefault(
            0 if parent is None else parent.nid, []).append(node)
        if parent is not None:
            parent.n_children += 1
        self.alloc.pin(page)
        return node

    # -- eviction -----------------------------------------------------------

    def _evict_one(self) -> bool:
        """Unpin the coldest LEAF (interior nodes would strand their
        subtree's pins). Returns False when nothing is evictable."""
        victim = None
        for node in self._lru.values():  # iterates cold -> hot
            if node.n_children == 0:
                victim = node
                break
        if victim is None:
            return False
        del self._lru[victim.nid]
        pid = 0 if victim.parent is None else victim.parent.nid
        self._children[pid].remove(victim)
        if not self._children[pid]:
            del self._children[pid]
        if victim.parent is not None:
            victim.parent.n_children -= 1
        if victim.n_valid == self.page_size:
            del self._full[(pid, victim.tokens)]
        self.alloc.unpin(victim.page)
        self.n_evicted += 1
        return True

    def evict(self, need: int = 1) -> int:
        """Allocator reclaim hook: evict cold entries until ``need`` pages
        landed on the free list (an unpin only frees a page nobody else
        shares) or nothing evictable remains. Returns pages freed."""
        before = self.alloc.n_free
        while self.alloc.n_free - before < need:
            if not self._evict_one():
                break
        return self.alloc.n_free - before

    def flush(self) -> int:
        """Drop every entry (unpinning all pages). Returns entries
        removed."""
        n = 0
        while self._evict_one():
            n += 1
        assert not self._lru, "flush left non-leaf cycles"
        return n
