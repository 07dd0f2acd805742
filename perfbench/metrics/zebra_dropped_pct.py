"""zebra_dropped_pct: the share of routed token copies that zebra's
capacity packs dropped in the traced window (``core/zebra_spmd.py``
``read_stats()["dropped_share"]``, collected in the traced run only: the
counter synchronizes)."""


def read(t):
    stats = t.info.get("zebra")
    if not stats or not stats.get("copies"):
        return None
    return 100.0 * stats["dropped_share"]
