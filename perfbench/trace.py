"""Reading a ``torch.profiler`` trace of the window: kernels by name,
family and stream, the benchmark's own host spans, busy time, stream
overlap and idle gaps named by the span the host was in.

The kernel families and the stream arithmetic are copied from the port's
``launch/profile_serve.py`` (``FAMILIES``) and ``launch/profile_train.py``
(``streams_report``), with the flash family widened to the tensor-core
backward kernels (``flash_dq_wgmma_kernel`` / ``flash_dkv_wgmma_kernel``,
which the original table files under "other")."""

from __future__ import annotations

import dataclasses

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("gmm_glu (port)", (
        "gmm_kernel<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, true",
        "gmm_kernel<float, float, float, true")),
    ("gmm_glu wgmma (port)", ("gmm_glu_wgmma_kernel",)),
    ("gmm wgmma (port)", ("gmm_wgmma_kernel",)),
    ("gmm f32 wgmma, W [G,K,N] (port)", ("WeightKN",)),
    ("gmm f32 wgmma, W^T (port)", ("WeightNK",)),
    ("gmm (port)", ("gmm_kernel<",)),
    ("gmm_dw wgmma (port)", ("gmm_dw_wgmma_kernel",)),
    ("gmm_dw (port)", ("gmm_dw_kernel",)),
    ("paged_decode (port)", ("paged_decode_",)),
    ("flash (port)", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel",
                      "flash_dq_kernel", "flash_dkv_kernel",
                      "flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel")),
    ("ssd (port)", ("ssd_scan_kernel", "ssd_chunk_states_kernel",
                    "ssd_state_pass_kernel", "ssd_chunk_out_kernel")),
    ("library gemm", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "gemv",
                      "nvjet")),
    ("memcpy / memset", ("memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy")),
    ("indexing", ("index", "scatter", "gather", "nonzero", "where")),
    ("reduction / softmax / sort", ("reduce", "softmax", "sort", "cumsum",
                                    "scan", "topk", "radix", "max", "sum")),
)
# The port's grouped-GEMM kernels of the expert FFN, every design.
EXPERT_GEMM = frozenset(f for f, _ in FAMILIES
                        if f.startswith(("gmm", "gmm_dw")))
FLASH = frozenset({"flash (port)"})
SPANS = ("data", "gradient", "optimizer", "sync")  # the benchmark's own


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


@dataclasses.dataclass
class Kernel:
    name: str
    family: str
    start: float  # µs, the profiler's clock
    end: float
    stream: int


@dataclasses.dataclass
class Trace:
    """What a per-layer reader reads: the window's kernels and spans, its
    host length, the steps it held, and the run's own counts."""

    kernels: list
    spans: list          # (start µs, end µs, name), sorted by start
    window_s: float
    steps: int
    info: dict           # model, batch, zebra stats, peak memory, ...

    def busy_us(self) -> float:
        return union_us((k.start, k.end) for k in self.kernels)

    def family_us(self, families) -> float:
        return sum(k.end - k.start for k in self.kernels
                   if k.family in families)


def from_profile(prof, window_s: float, steps: int, info: dict) -> Trace:
    """The device kernels (CUDA events that are not a span's device
    shadow) and the benchmark's host spans of a finished profile."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, spans = [], []
    for e in prof.events():
        if e.device_type == cuda:
            if e.name not in SPANS:
                kernels.append(Kernel(e.name, family(e.name),
                                      e.time_range.start, e.time_range.end,
                                      int(e.device_resource_id)))
        elif e.name in SPANS:
            spans.append((e.time_range.start, e.time_range.end, e.name))
    spans.sort()
    kernels.sort(key=lambda k: k.start)
    return Trace(kernels=kernels, spans=spans, window_s=window_s,
                 steps=steps, info=info)


def merged(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_us(intervals) -> float:
    return sum(b - a for a, b in merged(intervals))


def streams(t: Trace) -> dict:
    """{stream id: its kernels}."""
    per: dict = {}
    for k in t.kernels:
        per.setdefault(k.stream, []).append(k)
    return per


def overlap_us(t: Trace) -> float:
    """Device time during which kernels of two or more streams run at
    once."""
    edges = []
    for ks in streams(t).values():
        for a, b in merged((k.start, k.end) for k in ks):
            edges += [(a, 1), (b, -1)]
    total, active, last = 0.0, 0, None
    for when, step in sorted(edges):
        if active >= 2:
            total += when - last
        active += step
        last = when
    return total


def span_at(t: Trace, when: float) -> str:
    """The innermost benchmark span open at ``when`` ("host" if none)."""
    best = None
    for a, b, name in t.spans:
        if a > when:
            break
        if a <= when <= b and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else "host"


def idle_gaps(t: Trace) -> list:
    """[(span name, seconds)] of every gap between busy intervals inside
    the window's spans, longest first."""
    if not t.spans:
        return []
    lo = min(a for a, _, _ in t.spans)
    hi = max(b for _, b, _ in t.spans)
    busy = merged((max(k.start, lo), min(k.end, hi)) for k in t.kernels
                  if k.end > lo and k.start < hi)
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((span_at(t, cur), (a - cur) / 1e6))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((span_at(t, cur), (hi - cur) / 1e6))
    return sorted(gaps, key=lambda g: -g[1])


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time (by kernel name, with its
    family) and the longest idle gaps (by the span the host was in)."""
    by_name: dict = {}
    for k in t.kernels:
        key = f"{k.family}: {k.name[:100]}"
        by_name[key] = by_name.get(key, 0.0) + (k.end - k.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle_gaps(t)[:top]]}
