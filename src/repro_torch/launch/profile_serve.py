"""Where the time of a serve run goes, on the card (torch.profiler).

Takes the serve driver's flags, serves the trace once to warm up (kernel
build, allocator caches), then serves it again on a fresh engine with the
same weights under ``torch.profiler`` and reports:

* host wall time of the profiled run, and the device's busy and idle share
  of it (busy = union of kernel intervals);
* device time by kernel family (the port's CUDA kernels by name; library
  GEMMs; elementwise, indexing and reduction kernels; the rest);
* per engine phase (prefill chunks, decode steps): calls, host time and
  the device time of the kernels that ran inside them (each profiled step
  ends in a device synchronize, so its kernels run within its span);
* the kernels with the most device time, by name.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch mixtral-w2 --paged --page-size 16 --prefill-chunk 256 \\
        --prompt-len 384 --gen 32 --slots 4 --requests 6 \\
        --out chiprun_out/profile_serve.json

Needs a CUDA device (it measures the card, never the CPU).
"""

from __future__ import annotations

import bisect
import json
import pathlib
import sys
import time

import torch

from repro_torch.launch import serve as serve_mod
from repro_torch.models import registry, stack
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.serve import ServeConfig, build_deployment

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("gmm_glu (port)", (  # gmm_kernel<TA, TB, TO, GLU, TRANS_B>
        "gmm_kernel<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, true",
        "gmm_kernel<float, float, float, true")),
    ("gmm_glu wgmma (port)", ("gmm_glu_wgmma_kernel",)),  # bf16 GLU
    ("gmm wgmma (port)", ("gmm_wgmma_kernel",)),  # bf16 operands
    # f32 x bf16 by the weight's layout (the kernel's tag): the row-major
    # wo of y = h @ wo, and the transposed weights of dh and dx
    ("gmm f32 wgmma, W [G,K,N] (port)", ("WeightKN",)),
    ("gmm f32 wgmma, W^T (port)", ("WeightNK",)),
    ("gmm (port)", ("gmm_kernel<",)),
    ("gmm_dw wgmma (port)", ("gmm_dw_wgmma_kernel",)),  # 3-term bf16 split
    ("gmm_dw (port)", ("gmm_dw_kernel",)),
    ("paged_decode split (port)", ("paged_decode_split_kernel",)),
    ("paged_decode combine (port)", ("paged_decode_combine_kernel",)),
    ("flash (port)", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel",
                      "flash_dq_kernel", "flash_dkv_kernel")),
    ("ssd (port)", ("ssd_scan_kernel",  # FMA; then the wgmma design's 3
                    "ssd_chunk_states_kernel", "ssd_state_pass_kernel",
                    "ssd_chunk_out_kernel")),
    ("library gemm", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "gemv",
                      "nvjet")),
    ("memcpy / memset", ("memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy")),
    ("indexing", ("index", "scatter", "gather", "nonzero", "where")),
    ("reduction / softmax / sort", ("reduce", "softmax", "sort", "cumsum",
                                    "scan", "topk", "radix", "max", "sum")),
)
PHASES = ("prefill_chunk", "decode_step")  # record_function names


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _timed(name: str, fn):
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            out = fn(*a, **k)
            torch.cuda.synchronize()
            return out
    return wrapped


def profile(args) -> dict:
    cfg = registry.get_config(args.arch)
    if args.smoke:
        cfg = registry.smoke_config(cfg)
    run = RunConfig(policy=Policy(), moe_impl="gather")
    sc = ServeConfig.from_args(args)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = stack.init_model(gen, cfg, device="cuda")

    def trace():
        return serve_mod.build_trace(args.seed, args.requests, args.rate,
                                     args.prompt_len, args.gen,
                                     cfg.vocab_size, sc.sampling)

    build_deployment(cfg, run, sc, params=params, device="cuda").run(trace())
    engine = build_deployment(cfg, run, sc, params=params, device="cuda")
    engine.p.prefill_step = _timed("prefill_chunk", engine.p.prefill_step)
    engine.p.decode_step = _timed("decode_step", engine.p.decode_step)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.run(trace())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    return {"arch": cfg.name, **report(prof, wall_us, PHASES)}


def report(prof, wall_us: float, phase_names) -> dict:
    """The profile ``prof`` of a host window of ``wall_us``: the device's
    busy and idle share, device time by kernel family, the top kernels
    and every kernel of the port's own (by name), and per phase (a ``record_function`` span that ends in a device
    synchronize, so its kernels run within it) the calls, host time and
    device time of its kernels."""
    kernels, spans = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name not in phase_names:  # the annotations' device spans
                kernels.append(e)
        elif e.name in phase_names:
            spans.append((e.time_range.start, e.time_range.end, e.name))
    spans.sort()
    phases = {n: {"calls": 0, "host_ms": 0.0, "device_ms": 0.0}
              for n in phase_names}
    for a, b, n in spans:
        phases[n]["calls"] += 1
        phases[n]["host_ms"] += (b - a) / 1e3
    by_family, by_name = {}, {}
    for k in kernels:
        a, b = k.time_range.start, k.time_range.end
        for key, table in ((family(k.name), by_family),
                           (k.name[:120], by_name)):
            row = table.setdefault(key, {"ms": 0.0, "n": 0})
            row["ms"] += (b - a) / 1e3
            row["n"] += 1
        i = bisect.bisect_right(spans, (a, float("inf"), "")) - 1
        if i >= 0 and spans[i][0] <= a <= spans[i][1]:
            phases[spans[i][2]]["device_ms"] += (b - a) / 1e3
    busy_us = _union_us((k.time_range.start, k.time_range.end)
                        for k in kernels)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])
    top = ranked[:15]
    return {
        "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernels_launched": len(kernels),
        "by_family": dict(sorted(by_family.items(),
                                 key=lambda kv: -kv[1]["ms"])),
        "phases": phases,
        "top_kernels": dict(top),
        "port_kernels": {n: r for n, r in ranked
                         if family(n).endswith("(port)")},
    }


def main(argv=None) -> int:
    ap = serve_mod.build_parser()
    ap.add_argument("--out", default=None,
                    help="also write the report as JSON to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[profile] needs a CUDA device", file=sys.stderr)
        return 2
    if args.arch is None:
        print("[profile] pass --arch", file=sys.stderr)
        return 1
    rep = profile(args)
    print(json.dumps(rep, indent=1))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
