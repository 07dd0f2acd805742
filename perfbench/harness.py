"""One run of one cell, end to end: the device check, the cell's driver,
the per-layer readers, the check for JAX in the process, and the result's
one JSON line (the last line of standard output; the numbers compared,
each beside its limit, are the last lines of standard error too)."""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def parse(argv):
    ap = argparse.ArgumentParser(description="benchmark of repro_torch")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, the
    JAX package's or the JAX benchmarks' (compared whole: ``repro_torch``
    is not ``repro``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    """The card's power limit in W (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result_line(cell, out: dict, traced: bool, device: dict) -> dict:
    """The contract's object: end-to-end metrics untraced, the cell's
    per-layer metrics traced (a reader that finds nothing is left out)."""
    from perfbench import spec
    from perfbench import trace as T
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = spec.load_reader(m["name"])(out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if traced:
        t = out["trace"]
        device["busy_s"] = t.busy_us() / 1e6
        device["window_s"] = t.window_s
        line["breakdown"] = T.breakdown(t)
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                      for k, v in out["checks"].items()}
    return line


def main(argv=None, t_start: float = 0.0, *, require_chip: bool = True,
         device: str = "cuda", fault=None, cell=None) -> int:
    """Run the cell; 0 with the result printed, else non-zero and no
    result. ``require_chip=False``, ``device``, ``fault`` and ``cell`` (a
    ``spec.Cell`` in place of the one named) are for the harness's own
    tests on the CPU."""
    args = parse(argv)
    from perfbench import spec
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(spec.ROOT / "build" / "triton"))
    if cell is None:
        cell = spec.find_cell(args.workload)
    import torch
    if require_chip:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"[perfbench] {args.workload} needs {cell.chips} CUDA "
                  f"device(s); {have} present", file=sys.stderr)
            return 2
    src = spec.ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    torch.set_num_threads(min(4, torch.get_num_threads()))
    driver = spec.load_driver(cell.traffic["kind"])
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     t_start, device=device, fault=fault)
    bad = forbidden_modules()
    if bad:
        print(f"[perfbench] the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu",
           "count": cell.chips, "memory_peak_bytes": out["peak_bytes"]}
    if device == "cuda":
        dev["power_limit_w"] = power_limit()
    line = result_line(cell, out, bool(args.trace), dev)
    for name, c in out["checks"].items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        print(f"[perfbench] check {name} {c['value']!r} limit "
              f"{c['limit']!r} at {c['at']} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    print(f"[perfbench] correct={line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
