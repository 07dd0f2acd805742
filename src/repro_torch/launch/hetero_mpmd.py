"""Disaggregated training through the zebra MPMD engine (the port's
counterpart of ``examples/hetero_mpmd.py``).

It plans a ZP group with the port's planner, as the example does: the
paper's O-testbed classes (4 A40 attention devices, 4 V100 expert
devices), ``mixtral-w1``, global batch 16 of 4096 tokens
(``planner.plan_zp_group``: R, per-layer Asym-EA offloads and the
simulated iteration time, with and without Asym-EA). The offloads are
clamped to ``E // 2`` per layer, as the example clamps them, and the
engine (``core/zebra_mpmd.py``) is built with 4 expert lanes and 2
microbatches. Then it runs train steps: the forward and the
stage-recompute backward in Theorem 1's issue order, returning the loss
and the gradients. The engine applies no optimizer, as the reference's
does not, so ``--steps n`` repeats the same step on the same params and
batch.

The default is full width on the card: ``mixtral-w1`` (4 layers, d_model
2048, 12 experts top-2, d_ff 7168), bf16 compute with f32 params,
chunked attention, batch 8 x seq 256, capacity 1.25 (C 216 rows per
expert at 1024 tokens a microbatch; ``--n-chunks 2``: C 224 in chunks of
112). ``--smoke`` is the example itself: the smoke-size W1 with 4 layers,
capacity factor 8, f32 compute, the materialized reference attention,
batch 8 x seq 64. Weights and tokens are random, from ``--seed``.

    # full width on the card (one H100: attention and the 4 lanes share
    # it, each lane on a CUDA stream of its own)
    PYTHONPATH=src python -m repro_torch.launch.hetero_mpmd --steps 3

    # the example's smoke size on the CPU
    PYTHONPATH=src python -m repro_torch.launch.hetero_mpmd --smoke \\
        --device cpu

    # the example's own layout: 4 attention ranks and 4 expert lanes, one
    # process each (8 gloo ranks on the CPU; on CUDA one card a rank)
    PYTHONPATH=src python -m repro_torch.launch.hetero_mpmd --smoke \\
        --device cpu --ranks 4x4

``--ranks MxN`` runs the engine across M + N ranks through
``launch.mesh.launch_ranks`` (``core/zebra_mpmd_ranks.py``): ranks 0..M-1
attention, each on a block of every microbatch's rows, ranks M..M+N-1
the expert lanes; the ZP group is planned at that M and N. Every rank
builds the same seeded model and keeps its own part; rank 0 prints the
loss and each rank's role and experts. On CUDA a world larger than the
cards raises ``WorldTooLarge``; a rank that fails fails the run.

It runs on the CUDA device unless ``--device cpu`` is given; without a
CUDA device and without ``--device cpu`` it exits 2; a non-finite loss or
gradient exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import torch

from repro_torch.core import hardware as HW
from repro_torch.core.planner import ZebraPlan, plan_zp_group
from repro_torch.core.profiler import ZPGroupShape
from repro_torch.core.zebra_mpmd import ZebraMPMD
from repro_torch.core.zebra_mpmd_ranks import RankGroups, ZebraMPMDRanks
from repro_torch.kernels.ops import packed_block_m
from repro_torch.launch.mesh import launch_ranks, parse_mesh
from repro_torch.models import registry, stack
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.pytree import flatten

ARCH = "mixtral-w1"
# The example's ZP group and batch geometry, planned on the full model.
ZP = ZPGroupShape(M=4, N=4, attn_class=HW.A40, exp_class=HW.V100)
PLAN_BATCH, PLAN_SEQ = 16, 4096
MICROBATCHES = 2
BATCH, SEQ, SMOKE_SEQ = 8, 256, 64
SEED = 0


@dataclasses.dataclass
class Setup:
    """What one run trains: the plan, the engine, its placed params and
    the batch (``params`` is the fused tree the placement views)."""
    cfg: object
    run: RunConfig
    plan: ZebraPlan
    offload: tuple
    engine: ZebraMPMD
    params: dict
    attn_side: dict
    exp_layers: list
    tokens: torch.Tensor
    targets: torch.Tensor

    @property
    def microbatch_tokens(self) -> int:
        return self.tokens.numel() // self.engine.R


def plan(M: int = ZP.M, N: int = ZP.N) -> ZebraPlan:
    """The ZP group's plan, at M attention and N expert devices of the
    example's classes."""
    zp = dataclasses.replace(ZP, M=M, N=N)
    return plan_zp_group(registry.get_config(ARCH), zp,
                         global_batch=PLAN_BATCH, seq_len=PLAN_SEQ)


def model(smoke: bool):
    """(cfg, run) of the full-width default or of the example's smoke
    size."""
    cfg = registry.get_config(ARCH)
    if smoke:
        cfg = dataclasses.replace(registry.smoke_config(cfg), n_layers=4,
                                  capacity_factor=8.0)
        return cfg, RunConfig(policy=Policy(compute_dtype=torch.float32),
                              moe_impl="gather")
    return cfg, RunConfig(policy=Policy(), attn_impl="chunked",
                          moe_impl="gather")


def make_engine(args, cfg, run, offload, *, capacity_factor=None,
                streams: bool = True,
                ranks: RankGroups | None = None) -> ZebraMPMD:
    """The engine of the command line, 2 microbatches: across ``ranks``
    (``--ranks``), else attention on ``args.device`` and the ZP group's N
    expert lanes there too."""
    if ranks is not None:
        return ZebraMPMDRanks(cfg, run, ranks, MICROBATCHES, offload,
                              capacity_factor, args.n_chunks)
    dev = torch.device(args.device)
    return ZebraMPMD(cfg, run, attn_devices=[dev],
                     exp_devices=[dev] * ZP.N, num_microbatches=MICROBATCHES,
                     offload=offload, capacity_factor=capacity_factor,
                     n_chunks=args.n_chunks, streams=streams)


def build(args, *, capacity_factor=None, run: RunConfig | None = None,
          ranks: RankGroups | None = None) -> Setup:
    """The plan, the engine and its placed params, and one batch of 8 x
    256 tokens (8 x 64 with ``--smoke``), seeded, on ``args.device``;
    ``run`` replaces the run policy of :func:`model`. Across ``ranks``
    each rank keeps its own part of the params (``Setup.params`` None)."""
    cfg, default_run = model(args.smoke)
    run = run or default_run
    zp_plan = plan() if ranks is None else plan(ranks.M, ranks.N)
    offload = tuple(min(o, cfg.n_experts // 2)
                    for o in zp_plan.offload[:cfg.n_layers])
    engine = make_engine(args, cfg, run, offload,
                         capacity_factor=capacity_factor, ranks=ranks)
    dev = torch.device(args.device) if ranks is None else ranks.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = stack.init_model(gen, cfg, device=dev)
    attn_side, exp_layers = engine.shard_params(params)
    if ranks is not None:
        params = None
    shape = (BATCH, SMOKE_SEQ if args.smoke else SEQ)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                           device=dev)
    targets = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                            device=dev)
    return Setup(cfg, run, zp_plan, offload, engine, params, attn_side,
                 exp_layers, tokens, targets)


def step(s: Setup):
    """One train step: (loss, grads_attn, grads_exp)."""
    return s.engine.train_step(s.attn_side, s.exp_layers, s.tokens,
                               s.targets)


def finite(loss, grads_attn, grads_exp) -> bool:
    """Whether the loss and every gradient are finite (a rank of
    ``--ranks`` returns only its side's: the other is None)."""
    trees = []
    if grads_attn is not None:
        trees += [{k: v for k, v in grads_attn.items() if k != "layers"},
                  *grads_attn["layers"]]
    if grads_exp is not None:
        trees += [lane for layer in grads_exp for lane in layer]
    leaves = [t for tree in trees for t in flatten(tree).values()]
    return math.isfinite(float(loss)) and all(
        bool(torch.isfinite(t).all()) for t in leaves)


def layout(s: Setup) -> dict:
    """What the engine packs for one microbatch: capacity C, chunk rows,
    the row tile (block_m) of the lanes' chunks and of the attention
    group's offloaded experts, and per layer the offloaded experts and
    those of each lane. Across ranks: each rank's role and experts; the
    offloaded experts' rows are then each attention rank's own, in a
    buffer of its own capacity (no single block_m)."""
    eng = s.engine
    C, Cq = eng.capacity(s.microbatch_tokens)
    L = s.cfg.n_layers
    out = {"C": C, "C_chunk": Cq, "n_chunks": eng.Q,
           "block_m_lane_chunk": packed_block_m([Cq]),
           "block_m_local": packed_block_m([C]),
           "offload": list(s.offload),
           "attn_experts": [eng.plan.n_attn_experts(l) for l in range(L)],
           "experts_per_lane": [eng.lane_experts(l) for l in range(L)]}
    if isinstance(eng, ZebraMPMDRanks):
        out["block_m_local"] = None
        out["ranks"] = eng.describe()
    return out


def train(args, ranks: RankGroups | None = None) -> dict:
    """Plan, build and run ``args.steps`` steps (on this rank of ``ranks``
    with ``--ranks``); returns a summary (per step loss and host-clock ms
    around work that ends in a device synchronize; ms/step the median of
    the steps after the first, or the first alone; tokens/s; ``ok``: every
    loss and gradient finite)."""
    s = build(args, ranks=ranks)
    p = s.plan
    where = (f"device={args.device}" if ranks is None else
             f"ranks={ranks.M}x{ranks.N} device={args.device}")
    print(f"planned R={p.R} offload={p.offload} "
          f"iter={p.predicted.iter_time * 1e3:.1f}ms "
          f"(no-asym {p.predicted_no_asym.iter_time * 1e3:.1f}ms); engine "
          f"offload={s.offload} lanes={s.engine.N} R={MICROBATCHES} "
          f"Q={args.n_chunks} {where}", flush=True)
    if ranks is not None:
        for r in s.engine.describe():
            print(f"rank {r['rank']}: {r['role']}"
                  + (f", rows {r['rows']}" if "rows" in r else "")
                  + ", experts by layer "
                  + " ".join(f"[{lo},{hi})" for lo, hi in r["experts"]),
                  flush=True)
    dev = torch.device(args.device) if ranks is None else ranks.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses, step_s, ok = [], [], True
    for i in range(args.steps):
        sync()
        t0 = time.perf_counter()
        loss, ga, ge = step(s)
        sync()
        step_s.append(time.perf_counter() - t0)
        ok = ok and finite(loss, ga, ge)
        losses.append(float(loss))
        print(f"step {i + 1} loss={losses[-1]:.4f} "
              f"{step_s[-1] * 1e3:.1f} ms", flush=True)
    timed = step_s[1:] or step_s
    ms = sorted(timed)[len(timed) // 2] * 1e3
    print(f"disaggregated loss: {losses[-1]:.4f}", flush=True)
    return {"ok": ok, "losses": losses, "step_s": step_s,
            "ms_per_step": ms, "tokens_per_s": s.tokens.numel() / (ms / 1e3),
            "plan": {"R": p.R, "offload": list(p.offload),
                     "n_chunks": p.n_chunks,
                     "iter_s": p.predicted.iter_time,
                     "iter_s_no_asym": p.predicted_no_asym.iter_time},
            "layout": layout(s)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="zebra MPMD training run (planner + engine)")
    ap.add_argument("--smoke", action="store_true",
                    help="the example's smoke size (4 layers, f32, 8 x 64)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; fails without a CUDA device) or "
                         "cpu (plain versions of the kernels)")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--n-chunks", type=int, default=1,
                    help="capacity chunks per expert hop")
    ap.add_argument("--ranks", default=None, metavar="MxN",
                    help="M attention ranks and N expert lanes, one process "
                         "each (gloo on cpu, NCCL on cuda: a card a rank)")
    return ap


def _rank_main(rank: int, argv) -> None:
    """One rank of ``--ranks MxN`` (``launch_ranks`` target): rank 0
    prints, the others write nothing to stdout. CPU ranks share the
    host's cores: each takes its share of the intra-op threads."""
    args = build_parser().parse_args(argv)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    M, N = parse_mesh(args.ranks, "--ranks", "MxN")
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (M + N)))
    summary = train(args, RankGroups(M, N, args.device))
    if not summary["ok"]:
        raise RuntimeError(f"rank {rank}: a loss or gradient is not finite")
    print("MPMD hetero run OK", flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[mpmd] no CUDA device: the port trains on the card; pass "
              "--device cpu to run the plain versions on the CPU",
              file=sys.stderr)
        return 2
    if args.ranks:
        M, N = parse_mesh(args.ranks, "--ranks", "MxN")
        launch_ranks(_rank_main, M + N, args.device,
                     list(sys.argv[1:] if argv is None else argv))
        return 0
    summary = train(args)
    if not summary["ok"]:
        print("[mpmd] FAIL: a loss or gradient is not finite",
              file=sys.stderr)
        return 1
    print("MPMD hetero run OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
