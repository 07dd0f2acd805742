"""Where the time of a train step goes, on the card (torch.profiler).

Takes the train driver's flags, trains one step to warm up, then profiles
``--steps`` more steps. Each step is split into its two phases, each
ending in a device synchronize: ``gradient`` (the forward, with the
per-layer recompute, and the backward) and ``optimizer`` (AdamW). It
reports, as ``launch/profile_serve.py`` does for serving:

* host wall time of the profiled steps, and the device's busy and idle
  share of it;
* device time by kernel family (the port's CUDA kernels by name: the
  grouped GEMMs, the f32-lhs one split by its weight's layout, flash
  attention, the SSD scan; library GEMMs; elementwise, indexing and
  reduction kernels; the rest);
* per phase: calls, host time and the device time of its kernels;
* the kernels with the most device time, by name;
* the device time of the SSD scan's backward (the ``_SSD`` Function's
  autograd node and every kernel its ops launch: autograd of
  ``ref.ssd_chunked``), 0 for models without SSD layers;
* device memory: what params and optimizer state hold, and the peak of
  the profiled steps (``torch.cuda.max_memory_allocated``);
* per CUDA stream (the profiler's stream id of each kernel): its kernels,
  device-busy time (the union of its kernel intervals) and its largest
  kernel families; and the device time during which kernels of two or
  more streams run at once (``overlap_ms``). Under zebra parallelism (the
  driver's default for MoE archs) attention runs on the caller's stream
  and the experts on a second one, so ``overlap_ms`` is the overlap zebra
  exists for; without zebra every kernel is on one stream.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        --arch mixtral-w1 --no-zebra --steps 3 --batch 8 --seq 256 \\
        --out chiprun_out/profile_train.json

    # zebra (the driver's default for MoE archs: replicated, 2 microbatches)
    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        --arch mixtral-w1 --steps 3 --batch 8 --seq 256 \\
        --out chiprun_out/profile_train_zebra.json

    # mamba2 at full width and depth (the SSD scan kernel):
    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        --arch mamba2-2.7b --steps 3 --batch 2 --seq 2048 \\
        --out chiprun_out/profile_train_mamba2.json

Needs a CUDA device (it measures the card, never the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

import torch

from repro_torch.launch import train as train_mod
from repro_torch.launch.profile_serve import family, report
from repro_torch.train import optimizer as opt

PHASES = ("gradient", "optimizer")  # record_function names
SSD_BACKWARD = "autograd::engine::evaluate_function: _SSDBackward"


def _merged(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def streams_report(prof, phase_names=PHASES) -> dict:
    """Device time per CUDA stream and the time two or more streams run
    kernels at once, from the profiler's per-kernel stream ids (the
    device spans of the ``phase_names`` annotations left out)."""
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.name not in phase_names:
            per.setdefault(e.device_resource_id, []).append(e)
    streams, edges = {}, []
    for sid, evs in sorted(per.items()):
        spans = [(e.time_range.start, e.time_range.end) for e in evs]
        fams = {}
        for e in evs:
            fams[family(e.name)] = fams.get(family(e.name), 0.0) \
                + (e.time_range.end - e.time_range.start) / 1e3
        merged = _merged(spans)
        streams[str(sid)] = {
            "kernels": len(evs),
            "busy_ms": sum(b - a for a, b in merged) / 1e3,
            "top_families": dict(sorted(fams.items(),
                                        key=lambda kv: -kv[1])[:4])}
        for a, b in merged:
            edges += [(a, 1), (b, -1)]
    overlap_us, active, last = 0.0, 0, None
    for t, step in sorted(edges, key=lambda ev: (ev[0], ev[1])):
        if active >= 2:
            overlap_us += t - last
        active += step
        last = t
    return {"streams": streams, "overlap_ms": overlap_us / 1e3}


def profile(args) -> dict:
    cfg, program, loader = train_mod.build(args.arch, args)
    params = program.init_params(seed=0)
    opt_state = program.init_opt(params)
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()

    def step():
        batch = next(loader)
        with torch.profiler.record_function("gradient"):
            grads, _ = program.grad_fn(params, batch)
            torch.cuda.synchronize()
        with torch.profiler.record_function("optimizer"):
            opt.adamw_update(program.opt_cfg, params, grads, opt_state)
            torch.cuda.synchronize()

    step()  # warm-up: library handles, allocator growth
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        wall_us = (time.perf_counter() - t0) * 1e6
    ssd_bwd_us = sum(e.device_time_total for e in prof.events()
                     if e.name == SSD_BACKWARD)
    return {"arch": cfg.name, "steps": args.steps, "batch": args.batch,
            "seq": args.seq,
            "zebra": (dataclasses.asdict(program.zcfg) if program.zcfg
                      else None),
            **report(prof, wall_us, PHASES), **streams_report(prof),
            "ssd_backward_device_ms": ssd_bwd_us / 1e3,
            "memory": {"state_bytes": state_bytes,
                       "peak_bytes": torch.cuda.max_memory_allocated()}}


def main(argv=None) -> int:
    ap = train_mod.build_parser()
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
