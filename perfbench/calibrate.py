"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed the program's three numbers against the
reference (sound runs), and on some seeds the control's (the reference
with e4m3 products, :data:`perfbench.reference.FP8`, in the program's
place) and each fault's (:mod:`perfbench.faults`). No measured window:
training's readings need none. One JSON line per reading.

    python3 perfbench/calibrate.py --workload w1.zebra.4k \\
        --seeds 101-112 --control 101,102,103 \\
        --faults half_batch:101,102,103 --out chiprun_out/cal.jsonl

Benchmark runs never run this."""

import pathlib
import sys

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def _seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None, *, device: str = "cuda", cell=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--precisions", default="fp8_e4m3",
                    help="the controls to read (reference.CONTROLS)")
    ap.add_argument("--faults", default="",
                    help="name:seeds;name:seeds (perfbench.faults)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from perfbench import spec
    sys.path.insert(0, str(spec.ROOT / "src"))
    import torch

    from perfbench import check
    from perfbench import reference as ref
    from perfbench.drivers import train as D
    from perfbench.faults import FAULTS
    from perfbench.model import MoESpec, draw_weights, nest
    from perfbench import gen

    cell = cell or spec.find_cell(args.workload)
    m = MoESpec.from_config(cell.config)
    program = D.build_program(m, cell.traffic, device)
    dev = torch.device(device)
    control = set(_seeds(args.control))
    faults = {}
    for item in filter(None, args.faults.split(";")):
        name, _, seeds = item.partition(":")
        faults[name] = set(_seeds(seeds))
    out, sink = [], open(args.out, "a") if args.out else None

    def fresh(seed):
        params = nest(draw_weights(m, seed, dev))
        n = int(cell.traffic["check_steps"])
        return D.Setup(m=m, traffic=cell.traffic, program=program,
                       params=params, opt_state=program.init_opt(params),
                       check_batches=gen.batches(cell.traffic, m.vocab,
                                                 seed, n),
                       pool=[], device=dev, seed=seed)

    def drop(s):
        s.params = s.opt_state = None
        import gc
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def emit(seed, kind, side, base, t):
        rec = {"workload": cell.name, "seed": seed, "kind": kind,
               "seconds": round(time.perf_counter() - t, 3),
               "losses": side.losses, "ref_losses": base.losses,
               "grads": side.grads, "ref_grads": base.grads,
               "changes": side.changes, "ref_changes": base.changes,
               "grad_diffs": check.diffs(side.grad_samples,
                                          base.grad_samples,
                                          list(base.grads)),
               "change_diffs": check.diffs(side.change_samples,
                                            base.change_samples,
                                            list(base.changes)),
               **{k: {"value": v, "at": at}
                  for k, (v, at) in check.gaps(side, base).items()}}
        out.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for seed in _seeds(args.seeds):
        t = time.perf_counter()
        s = fresh(seed)
        side, _ = D.check_steps(s, program.train_step)
        drop(s)
        base = D.reference_readings(s)
        emit(seed, "sound", side, base, t)
        if seed in control:
            for name in args.precisions.split(","):
                t = time.perf_counter()
                emit(seed, "control " + name, D.reference_readings(
                    s, ref.CONTROLS[name]), base, t)
        for name, seeds in faults.items():
            if seed in seeds:
                t = time.perf_counter()
                s = fresh(seed)
                bad, _ = D.check_steps(s, FAULTS[name](program))
                drop(s)
                emit(seed, name, bad, base, t)
    if sink:
        sink.close()
    return out


if __name__ == "__main__":
    main()
