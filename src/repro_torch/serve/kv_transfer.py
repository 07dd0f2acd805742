"""Page-granular KV transfer between paged pools (DESIGN.md §10, §13; the
port of the JAX package's ``serve/kv_transfer.py``).

The disaggregated handoff ships a finished prefill's KV from the prefill
group's pool to the decode group's pool by moving ONLY the request's
allocated physical pages: the source page ids come straight out of the
exporting allocator's table, the payload keeps the ``[n, page_size, ...]``
page layout end to end (a page-dim gather, never a contiguous
``[tokens, ...]`` cache), and the destination scatter lands the pages at
the importing allocator's ids — the request's logical cache is
reconstituted purely by the TABLE rewrite, in the virtual domain.

Transfers stream in §8-style fixed-size page chunks so a long prompt's
KV pipelines across the link instead of serializing behind one bulk copy
(and so every chunk has one shape, as the JAX package's jitted pair
needs: the final chunk is padded — source padding re-reads page 0 harmlessly, destination
padding uses the out-of-bounds sentinel, whose rows the scatter masks
out before its in-place write).

The transfer is TRANSACTIONAL per chunk (DESIGN.md §13): every chunk is
checksummed at the source and verified at the destination, a dropped or
corrupted chunk is retried with bounded exponential backoff, and a
delivered-but-unacknowledged chunk (link stall) is simply replayed — the
page-granular scatter is idempotent, so at-least-once delivery is safe.
When a chunk exhausts its retry budget the whole transfer aborts with
:class:`TransferAbortedError` and NOTHING has changed ownership: the
source pages are still in the exporting allocator's EXPORTED state
(rolled back via ``abort_export``) and the destination pages are still
under their import LEASE (rolled back via ``abort_import``). Faults come
from an optional :class:`~repro_torch.ft.chaos.FaultInjector` consulted at the
named hook points (drop / corrupt / stall per chunk, matched against the
receiving group's name; crash_mid_export / crash_mid_import between
chunks raise :class:`~repro_torch.ft.chaos.GroupCrashed`).

Both pools share one process and one device, so the "link" is a cost
model: :class:`TransferStats` accrues the simulated wire time
(per-chunk latency + bytes/bandwidth, plus timeout and backoff charges
on the retry path) that the serving simulator and bench report; the data
path itself is the real gather/scatter.

In the port the scatter writes the destination pools IN PLACE, so the
state a call returns, and the ``.dst_state`` its exceptions carry, are
the caller's own tree; the attribute and the caller's rebinding stay, so
the controller reads as the JAX one does. The per-chunk checksum views
every payload leaf as bytes on the device (bf16 has no numpy dtype) and
copies them to the host in ONE transfer: the CRC of the concatenation is
the chained CRC of the leaves, in the JAX package's tree order.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import List, Optional

import torch

from repro_torch.ft.chaos import FaultInjector, GroupCrashed
from repro_torch.models import stack
from repro_torch.obs import trace as obs_trace


class TransferAbortedError(RuntimeError):
    """A chunk exhausted its retry budget; the transfer rolled back —
    neither pool's ownership changed (source still EXPORTED, destination
    lease still open for the caller to abort)."""


def _leaves(tree) -> list:
    """The leaves of a payload tree in the JAX package's flatten order:
    dict keys sorted, lists in order, None empty."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _tree_crc(payload) -> int:
    """Host-side CRC32 over every leaf of a payload tree — the per-chunk
    checksum both ends of the link compute. Each leaf is viewed as its
    bytes where it lies, and all of them cross to the host in one copy. A
    payload without leaves (an SSD-only model ships no KV) checksums to 0,
    the CRC of no bytes, as in the JAX package."""
    leaves = [v.contiguous().view(torch.uint8).reshape(-1)
              for v in _leaves(payload)]
    if not leaves:
        return 0
    blob = torch.cat(leaves) if len(leaves) > 1 else leaves[0]
    return zlib.crc32(blob.cpu().numpy().tobytes())


def _flip_bits(payload):
    """Simulated wire corruption: flip the first byte of the first leaf
    (shape/dtype preserved, so only the checksum can tell). Returns a new
    tree; the other leaves are shared."""
    first = _leaves(payload)[0]

    def swap(tree):
        if isinstance(tree, dict):
            return {k: swap(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [swap(v) for v in tree]
        if tree is first:
            v = tree.clone()
            v.view(torch.uint8).reshape(-1)[:1].bitwise_xor_(0xFF)
            return v
        return tree

    return swap(payload)


@dataclasses.dataclass
class TransferStats:
    """Accrued transfer-engine accounting (one engine, many transfers)."""

    n_transfers: int = 0
    n_pages: int = 0          # real pages shipped (padding excluded)
    n_chunks: int = 0
    bytes: int = 0            # real payload bytes (padding excluded)
    sim_seconds: float = 0.0  # simulated link occupancy
    # -- robustness (DESIGN.md §13) --
    n_retries: int = 0            # chunk re-attempts after any fault
    n_timeouts: int = 0           # chunks lost on the wire / acks lost
    n_checksum_failures: int = 0  # corrupted chunks caught at the receiver
    n_replayed_chunks: int = 0    # delivered chunks re-applied (lost ack)
    n_aborts: int = 0             # transfers that exhausted their retries
    # The DISTINCT leaf shapes that crossed the link, for the structural
    # pages-only guarantee: tests assert each one is page-granular
    # [k, page_size, ...] and that no contiguous [tokens, ...] cache ever
    # materialized on the transfer path. Deduplicated so a long-lived
    # engine doesn't grow a per-chunk-per-leaf log without bound.
    shipped_shapes: List[tuple] = dataclasses.field(default_factory=list)

    def note_shapes(self, shapes) -> None:
        for s in shapes:
            if s not in self.shipped_shapes:
                self.shipped_shapes.append(s)


class KVTransferEngine:
    """Ships a request's KV pages between two paged decode-state trees.

    ``phase_s``: None (default) or a dict; when a dict, every attempt's
    gather, checksum and scatter are timed on the host clock with the
    device synchronized around each, and their seconds appended under
    "gather", "crc" and "scatter" (a measurement hook: the syncs cost
    time the untimed path does not spend)."""

    def __init__(self, *, chunk_pages: int = 4,
                 link_bw: Optional[float] = None, latency_s: float = 0.0,
                 max_retries: int = 3, timeout_s: float = 0.05,
                 backoff_s: float = 0.01, verify_checksums: bool = True,
                 chaos: Optional[FaultInjector] = None):
        assert chunk_pages >= 1 and max_retries >= 0
        self.chunk_pages = chunk_pages
        self.link_bw = link_bw
        self.latency_s = latency_s
        self.max_retries = max_retries
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s
        self.verify_checksums = verify_checksums
        self.chaos = chaos
        self.stats = TransferStats()
        self.phase_s = None
        self._gather = torch.inference_mode()(stack.gather_kv_pages)
        self._scatter = torch.inference_mode()(stack.scatter_kv_pages)

    def _timed(self, phase: str, fn, *args):
        """``fn(*args)``, timed into ``phase_s[phase]`` when it is on."""
        if self.phase_s is None:
            return fn(*args)
        _sync()
        t0 = time.perf_counter()
        out = fn(*args)
        _sync()
        self.phase_s.setdefault(phase, []).append(time.perf_counter() - t0)
        return out

    def _page_bytes(self, payload, n_pages_in_payload: int) -> int:
        """Payload bytes of ONE page across every layer's pools."""
        return sum(leaf.numel() * leaf.element_size()
                   for leaf in _leaves(payload)) \
            // max(n_pages_in_payload, 1)

    def transfer(self, src_state, dst_state, src_ids: List[int],
                 dst_ids: List[int], *, dst_n_pages: int,
                 src_name: str = "*", dst_name: str = "*",
                 rid: Optional[int] = None, src_pool=None, dst_pool=None):
        """Move pages ``src_ids`` of ``src_state``'s pools into pages
        ``dst_ids`` of ``dst_state``'s pools, chunk by chunk. Returns the
        destination state (written in place); the source state is
        read-only (its pages recycle via the exporting allocator, not
        here).

        On the serving mesh ``src_pool`` / ``dst_pool`` (the programs'
        ``serve.mesh.PoolShard``; None: a pool that is not split) name this
        rank's pages: a chunk is gathered from the pages each rank owns and
        all-gathered over "model" into the replicated payload, whose
        checksum is then the same on every rank, and each rank scatters it
        into the destination pages it owns.

        Raises :class:`TransferAbortedError` when a chunk exhausts its
        retry budget, and :class:`~repro_torch.ft.chaos.GroupCrashed` when
        a chaos crash fires between chunks — in both cases the caller
        rolls ownership back (``abort_export`` / ``abort_import``). Both
        exceptions carry the destination tree as ``.dst_state`` (the
        JAX package's donated scatter makes that the only live reference;
        here it is the caller's own tree) and the caller rebinds to it
        before rolling back. The partial writes only touched pages under
        the import lease, which ``abort_import`` returns to the free
        list — their contents are unreachable."""
        assert len(src_ids) == len(dst_ids) and src_ids, \
            "transfer needs matching non-empty page-id lists"
        chaos = self.chaos
        tr = obs_trace.TRACER
        track = f"xfer:{src_name}->{dst_name}"
        if tr.enabled:
            tr.declare_track(track, kind="meta")
            if rid is not None:
                tr.flow(track, "transfer", rid, pages=len(src_ids))
        n = len(src_ids)
        cp = self.chunk_pages
        for lo in range(0, n, cp):
            if chaos is not None:
                if chaos.fire("crash_mid_export", src_name):
                    tr.instant(track, "crash", side="src", rid=rid)
                    exc = GroupCrashed("src", src_name)
                    exc.dst_state = dst_state
                    raise exc
                if chaos.fire("crash_mid_import", dst_name):
                    tr.instant(track, "crash", side="dst", rid=rid)
                    exc = GroupCrashed("dst", dst_name)
                    exc.dst_state = dst_state
                    raise exc
            src_chunk = list(src_ids[lo:lo + cp])
            dst_chunk = list(dst_ids[lo:lo + cp])
            real = len(src_chunk)
            # Fixed chunk shape: pad the tail (src: re-read page 0 — the
            # dropped dst sentinel makes the duplicate write a no-op).
            src_chunk += [0] * (cp - real)
            dst_chunk += [dst_n_pages] * (cp - real)
            committed = False
            tr.begin(track, "chunk", idx=lo // cp, pages=real, rid=rid)
            for attempt in range(1 + self.max_retries):
                if attempt:
                    # Bounded exponential backoff before each retry,
                    # charged to the simulated link clock.
                    self.stats.n_retries += 1
                    self.stats.sim_seconds += \
                        self.backoff_s * (2 ** (attempt - 1))
                    tr.instant(track, "retry", idx=lo // cp,
                               attempt=attempt)
                payload = self._timed("gather", self._gather, src_state,
                                      src_chunk, src_pool)
                if chaos is not None and chaos.fire("drop", dst_name):
                    # Chunk lost on the wire: the receiver times out.
                    self.stats.n_timeouts += 1
                    self.stats.sim_seconds += self.timeout_s
                    tr.instant(track, "drop", idx=lo // cp)
                    continue
                crc = self._timed("crc", _tree_crc, payload) \
                    if self.verify_checksums else None
                if chaos is not None and chaos.fire("corrupt", dst_name):
                    payload = _flip_bits(payload)
                if crc is not None \
                        and self._timed("crc", _tree_crc, payload) != crc:
                    # Receiver-side checksum mismatch: discard, retry.
                    self.stats.n_checksum_failures += 1
                    tr.instant(track, "corrupt", idx=lo // cp)
                    continue
                dst_state = self._timed("scatter", self._scatter, dst_state,
                                        payload, dst_chunk, dst_pool)
                if chaos is not None and chaos.fire("stall", dst_name):
                    # Delivered but the ack is lost: the sender replays
                    # the chunk. The scatter writes the same pages to the
                    # same slots, so the at-least-once replay is safe —
                    # idempotence is the contract, exercised here.
                    self.stats.n_timeouts += 1
                    self.stats.n_replayed_chunks += 1
                    self.stats.sim_seconds += self.timeout_s
                    tr.instant(track, "replay", idx=lo // cp)
                    continue
                committed = True
                break
            tr.end(track, committed=committed)
            if not committed:
                self.stats.n_aborts += 1
                tr.instant(track, "abort", idx=lo // cp, rid=rid)
                exc = TransferAbortedError(
                    f"chunk {lo // cp} of {src_name}->{dst_name} "
                    f"exhausted {self.max_retries} retries")
                exc.dst_state = dst_state
                raise exc
            page_b = self._page_bytes(payload, cp)
            self.stats.n_chunks += 1
            self.stats.n_pages += real
            self.stats.bytes += real * page_b
            if self.link_bw:
                self.stats.sim_seconds += self.latency_s \
                    + real * page_b / self.link_bw
            self.stats.note_shapes(
                tuple(int(d) for d in leaf.shape)
                for leaf in _leaves(payload))
        self.stats.n_transfers += 1
        return dst_state


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
