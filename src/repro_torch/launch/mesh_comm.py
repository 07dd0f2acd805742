"""The collectives one step of the training mesh launches, by kind, with
their bytes, counted where they reach ``torch.distributed``.

It runs the train driver's program (``launch.train.build``: the driver's
run policy and zebra default) on a ``--mesh DxM`` of ranks, ``--steps``
steps on the driver's batches, and counts the collectives of the last
step on every rank: calls, the bytes of the whole tensor each one sums or
assembles (an all-reduce's tensor, an all-gather's output, a
reduce-scatter's input, an all-to-all's input), the operand bytes of the
JAX package's collective tally (an all-gather's input piece, the whole
tensor otherwise) and the bytes a rank sends on a ring (all-reduce 2
(n-1)/n of them, the others (n-1)/n, n the group's size; a message sent
point to point all of them, one received none). ``Counter`` is also the
dry run's tally (``launch/dryrun.py``, ``launch/hlo_analysis.py``). Rank
0 prints one ``[mesh_comm] {json}`` line (``--out``: also written there)
with rank 0's counts and every rank's totals.

    # zebra replicated ("hybrid" rules) on 2 CPU ranks (gloo):
    PYTHONPATH=src python -m repro_torch.launch.mesh_comm --arch \\
        mixtral-d2 --smoke --device cpu --mesh 1x2 --batch 8 --seq 32

It imports only what the mesh program has had since the training mesh
came in, so the same file, run by its path with ``PYTHONPATH`` on an
older checkout's ``src``, counts that checkout's step.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch
import torch.distributed as dist

KINDS = {"all_reduce": 2, "all_gather": 1, "reduce_scatter": 1,
         "all_to_all_single": 1, "broadcast": 1, "isend": None,
         "irecv": None}


def _payload(kind: str, args) -> int:
    """Bytes of the whole tensor a call sums or assembles."""
    if kind == "all_gather":           # (parts, t)
        return sum(t.nbytes for t in args[0])
    if kind == "reduce_scatter":       # (out, chunks)
        return sum(t.nbytes for t in args[1])
    if kind == "all_to_all_single":    # (out, inp)
        return args[1].nbytes
    return args[0].nbytes              # all_reduce, broadcast, p2p (t)


def _ring(kind: str, N: int, n: int) -> int:
    """Bytes a rank sends for a call of ``N`` payload bytes on a group of
    ``n`` ranks."""
    if KINDS[kind] is None:            # point to point: the sender's
        return N if kind == "isend" else 0
    return KINDS[kind] * (n - 1) * N // n


class Counter:
    """Wraps the ``torch.distributed`` collectives while it is on."""

    def __init__(self):
        self.on = False
        self.counts: dict = {}
        self.real = {k: getattr(dist, k) for k in KINDS}
        for kind in KINDS:
            setattr(dist, kind, self._wrap(kind))

    def _wrap(self, kind):
        real = self.real[kind]

        def call(*args, **kw):
            if self.on:
                n = dist.get_world_size(kw.get("group"))
                N = _payload(kind, args)
                c = self.counts.setdefault(kind, {
                    "calls": 0, "bytes": 0, "operand_bytes": 0,
                    "ring_bytes": 0})
                c["calls"] += 1
                c["bytes"] += N
                c["operand_bytes"] += args[1].nbytes \
                    if kind == "all_gather" else N
                c["ring_bytes"] += _ring(kind, N, n)
            return real(*args, **kw)
        return call

    def close(self):
        for k, f in self.real.items():
            setattr(dist, k, f)


def _rank(rank: int, argv, out):
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh, parse_mesh
    args = train_mod.build_parser().parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    mesh = make_mesh(parse_mesh(args.mesh), ("data", "model"), args.device)
    cfg, program, loader = train_mod.build(args.arch, args, mesh=mesh)
    params = program.init_params(seed=0)
    state = program.init_opt(params)
    counter = Counter()
    try:
        for step in range(args.steps):
            counter.on = step == args.steps - 1
            params, state, m = program.train_step(params, state,
                                                  next(loader))
            float(m["loss"])
    finally:
        counter.close()
    tot = {k: sum(c[k] for c in counter.counts.values())
           for k in ("calls", "bytes", "ring_bytes")}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, tot)
    if rank == 0:
        res = {"arch": cfg.name, "mesh": dict(mesh.shape),
               "batch": args.batch, "seq": args.seq,
               "zebra": (program.zcfg.mode if program.zcfg else None),
               "step": args.steps, "rank0": counter.counts,
               "per_rank_total": gathered}
        print("[mesh_comm] " + json.dumps(res), flush=True)
        if out:
            pathlib.Path(out).write_text(json.dumps(res, indent=1))


def main(argv=None) -> int:
    from repro_torch.launch.mesh import launch_ranks, parse_mesh
    from repro_torch.launch import train as train_mod
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="")
    own, rest = p.parse_known_args(argv)
    args = train_mod.build_parser().parse_args(rest)
    d, m = parse_mesh(args.mesh)
    launch_ranks(_rank, d * m, args.device, rest, own.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
