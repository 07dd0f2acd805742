"""zebra_overlap_pct: the device time in which kernels of two streams run
at once, as a share of the expert stream's busy time (the stream with the
most grouped-GEMM time; ``core/zebra_spmd.py`` runs the experts there and
attention on the caller's stream). Nothing to read on one stream."""

from perfbench import trace as T


def read(t):
    per = T.streams(t)
    if len(per) < 2:
        return None
    expert = max(per, key=lambda s: sum(k.end - k.start for k in per[s]
                                        if k.family in T.EXPERT_GEMM))
    busy = T.union_us((k.start, k.end) for k in per[expert])
    if busy <= 0:
        return None
    return 100.0 * T.overlap_us(t) / busy
