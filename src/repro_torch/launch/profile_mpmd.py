"""Where the time of a zebra MPMD train step goes, per CUDA stream, on the
card (torch.profiler).

Takes ``launch/hetero_mpmd.py``'s flags, runs one step to warm up, then
profiles ``--steps`` more, each ending in a device synchronize. It reports
what ``launch/profile_train.py`` reports for a step (host wall time, the
device's busy and idle share, device time by kernel family and the top
kernels, peak memory), the busy time of each CUDA stream and the time two
or more streams run kernels at once (``streams``, ``overlap_ms``), and the
time the attention stream runs beside any expert lane
(``attn_expert_overlap_ms``; ``attn_nongrouped_expert_overlap_ms``
counts only its kernels other than the grouped GEMMs, which run the
offloaded experts): the overlap Theorem 1's schedule exists for.
The attention stream is the caller's: the profile marks it with one
short spin kernel (``torch.cuda._sleep``) after the steps, finds the
stream that ran it, and leaves the marker out of every other number.

    PYTHONPATH=src python -m repro_torch.launch.profile_mpmd --steps 3 \\
        --out chiprun_out/profile_mpmd.json

Needs a CUDA device (it measures the card, never the CPU).
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

from repro_torch.launch import hetero_mpmd as hm
from repro_torch.launch.profile_serve import family, report
from repro_torch.launch.profile_train import _merged, streams_report

PHASES = ("step",)
MARK = "spin_kernel"  # the kernel of torch.cuda._sleep
MARK_CYCLES = 1000


class _Unmarked:
    """A profile's events without the marker kernel."""

    def __init__(self, prof):
        self._events = [e for e in prof.events() if MARK not in e.name]

    def events(self):
        return self._events


def _overlap_us(xs, ys) -> float:
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    both, i, k = 0.0, 0, 0
    while i < len(xs) and k < len(ys):
        (a, b), (c, d) = xs[i], ys[k]
        both += max(0.0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            k += 1
    return both


def attn_expert_overlap_ms(prof) -> dict:
    """The attention stream's id (the stream that ran the marker); the
    device ms during which it and at least one expert lane run kernels;
    and the same for its kernels other than the grouped GEMMs (attention
    blocks, routers, combines, head: the work the offloaded experts' X
    tasks do not account for)."""
    per, marked = {}, set()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name in PHASES:
            continue
        if MARK in e.name:
            marked.add(e.device_resource_id)
            continue
        per.setdefault(e.device_resource_id, []).append(
            (e.time_range.start, e.time_range.end,
             family(e.name).startswith("gmm")))
    if len(marked) != 1:
        raise RuntimeError(f"the marker kernel ran on streams {marked}")
    (attn,) = marked
    lanes = _merged([iv[:2] for sid, ivs in per.items() if sid != attn
                     for iv in ivs])
    mine = _merged([iv[:2] for iv in per[attn]])
    other = _merged([iv[:2] for iv in per[attn] if not iv[2]])
    return {"attn_stream": str(attn),
            "attn_expert_overlap_ms": _overlap_us(mine, lanes) / 1e3,
            "attn_nongrouped_expert_overlap_ms":
                _overlap_us(other, lanes) / 1e3}


def profile(args) -> dict:
    s = hm.build(args)
    hm.step(s)  # warm-up: library handles, allocator growth
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            with torch.profiler.record_function("step"):
                hm.step(s)
                torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        torch.cuda._sleep(MARK_CYCLES)  # on the engine's attention stream
        torch.cuda.synchronize()
    batch, seq = s.tokens.shape
    rest = _Unmarked(prof)
    return {"arch": s.cfg.name, "steps": args.steps, "batch": batch,
            "seq": seq, "lanes": s.engine.N, "microbatches": s.engine.R,
            "n_chunks": s.engine.Q, "layout": hm.layout(s),
            **report(rest, wall_us, PHASES), **streams_report(rest, PHASES),
            **attn_expert_overlap_ms(prof),
            "memory": {"peak_bytes": torch.cuda.max_memory_allocated()}}


def main(argv=None) -> int:
    ap = hm.build_parser()
    ap.add_argument("--out", default=None,
                    help="also write the report as JSON to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or args.device != "cuda":
        print("[profile] needs a CUDA device", file=sys.stderr)
        return 2
    rep = profile(args)
    print(json.dumps(rep, indent=1))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
