"""End-to-end training driver of the port (mirror of
``repro/launch/train.py``).

It takes the JAX driver's flags and runs the JAX driver's step: forward
with chunked attention and per-layer recompute (``remat="full"``), the
MoE FFN's recomputing backward through the grouped GEMM kernels, AdamW.
For MoE archs zebra parallelism is on by default, as in the JAX driver
(``--zebra-mode replicated``, ``--microbatches 2``): every MoE layer runs
``core/zebra_spmd.py``'s override, attention of microbatch k on one CUDA
stream beside the capacity-packed experts of microbatch k-1 on another;
``--no-zebra`` runs the dropless single-pack MoE path instead.
A mamba2 arch (``--arch mamba2-2.7b``) runs each SSD mixer's scan through
the SSD scan kernel (forward and its remat recompute) with the backward
by autograd of the chunked oracle; zebra applies to MoE archs only, so it
needs no ``--no-zebra``. An encoder-decoder or vision arch (``--arch
whisper-tiny``, ``--arch llama-3.2-vision-90b``) gets the JAX driver's
zero front embeddings at every step (``stack.zero_fronts``); whisper's
encoder runs under the same remat and attention path as the decoder.
A caller may hand :func:`build` / :func:`train_arch` another
``RunConfig`` (``attn_impl="flash"`` trains through the flash attention
kernels; ``remat="dots"``) or another ``ModelConfig`` (e.g. a cut
depth); the command line has no flag for them, as the JAX driver has
none.
It runs on the CUDA device unless ``--device cpu`` is given; without a
CUDA device and without ``--device cpu`` it exits non-zero.

As the JAX driver, it checkpoints and resumes (``--ckpt-dir``: an async
save every ``--ckpt-every`` steps with the data loader's state, and a
blocking save at the end, in the JAX package's format through
``checkpoint.CheckpointManager``; ``--resume`` restores the latest step
and its loader position) and traces (``--trace-out``: a Perfetto trace
on the step clock, ``--trace-wall`` adds wall-clock readings, with the
analytic zebra timeline of the reference A40/V100 pair laid beside it for
a zebra run, and the idle report printed).

    # the paper's Mixtral-W1 at full width and depth on the card (zebra
    # replicated, 2 microbatches: the JAX driver's default):
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-w1 \\
        --steps 6 --batch 8 --seq 256

    # the same with chunked all-to-all dispatch and 2 offloaded experts:
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-w1 \\
        --steps 6 --batch 8 --seq 256 --zebra-mode alltoall --n-chunks 2 \\
        --offload-experts 2

    # without zebra (the dropless single-pack MoE path):
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-w1 \\
        --no-zebra --mesh 1x1 --steps 6 --batch 8 --seq 256

    # whisper-tiny at full width and depth on the card (4 encoder layers
    # over 1500 frames, 4 decoder layers with cross-attention):
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
        --steps 6 --batch 8 --seq 256

    # mamba2-2.7b at full width and depth on the card (8 chunks of 256):
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
        --steps 6 --batch 2 --seq 2048

    # smoke size on the CPU (plain versions of the kernels):
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-w1 \\
        --smoke --device cpu --steps 2

    # checkpoint every 2 steps and trace; then resume from the checkpoint
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-w1 \\
        --smoke --device cpu --steps 4 --ckpt-dir build/ckpt \\
        --ckpt-every 2 --trace-out build/train_trace.json
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-w1 \\
        --smoke --device cpu --steps 6 --ckpt-dir build/ckpt --resume

``--mesh DxM`` trains on a D x M mesh of ranks as the JAX driver does
(``train/step.py``'s mesh program: 2D FSDP weights, experts over "model",
tensor-parallel attention under zebra replicated, ZeRO-1 moments),
through ``launch.mesh.launch_ranks``: one process per card (``cuda:r``,
NCCL), or per CPU rank with ``--device cpu`` (gloo). Every rank reads the
same global batch and keeps its rows; rank 0 alone prints, traces and
writes checkpoints (gathered from every rank's blocks, in the same
format), and a resumed run re-shards the checkpoint onto its own mesh.
``--mesh 1x1`` runs the same mesh program on one rank.

    # 2x2 on four CPU ranks (gloo):
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-d2 \\
        --smoke --device cpu --mesh 2x2 --steps 4 --batch 8 --seq 64

A malformed ``--mesh``, an unknown ``--zebra-mode`` and fewer than one
microbatch are rejected by name in one ``[train] invalid configuration:``
line, exit 1; so is a CUDA mesh with more ranks than cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import resource
import sys
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.zebra_spmd import MODES, ZebraConfig
from repro_torch.data import DataConfig, DataLoader
from repro_torch.launch.mesh import launch_ranks, make_mesh, parse_mesh
from repro_torch.models import registry, stack
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.obs import format_report, write_chrome_trace
from repro_torch.obs import trace as obs_trace
from repro_torch.pytree import flatten
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_program


def zebra_config(args, cfg) -> ZebraConfig | None:
    """The ZebraConfig of the command line (the JAX driver's,
    repro/launch/train.py:81-85): None with ``--no-zebra`` or for an arch
    without experts."""
    if not (args.zebra and cfg.is_moe):
        return None
    return ZebraConfig(mode=args.zebra_mode,
                       num_microbatches=args.microbatches,
                       n_chunks=args.n_chunks,
                       offload_experts=args.offload_experts)


def build(arch: str, args, run: RunConfig | None = None,
          zcfg: ZebraConfig | None = None, cfg: ModelConfig | None = None,
          mesh=None):
    """(cfg, program, loader) of the driver's command line: ``run``, by
    default the JAX driver's run policy (chunked attention, gather MoE,
    full remat, bf16 compute), the JAX driver's optimizer schedule, and
    ``zcfg``, by default the command line's (:func:`zebra_config`; a
    caller may hand another, e.g. with another capacity factor). ``cfg``,
    by default the registry's ``arch`` (``--smoke``: its smoke config), may
    be another config of the arch (a caller's cut of its depth). ``mesh``
    (``launch.mesh.Mesh``): the mesh program on its ranks; the loader
    yields the global batch on every rank."""
    if cfg is None:
        cfg = registry.get_config(arch)
        if args.smoke:
            cfg = registry.smoke_config(cfg)
    if run is None:
        run = RunConfig(policy=Policy(), attn_impl="chunked",
                        moe_impl="gather", remat="full")
    if zcfg is None:
        zcfg = zebra_config(args, cfg)
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    opt_cfg = opt.OptimizerConfig(peak_lr=args.lr, warmup_steps=20,
                                  total_steps=args.steps)
    program = make_train_program(
        cfg, run, shape, opt_cfg=opt_cfg,
        device=args.device if mesh is None else mesh.device, zcfg=zcfg,
        mesh=mesh)
    loader = DataLoader(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=args.seq, global_batch=args.batch,
                                   path=args.data))
    return cfg, program, loader


def train_arch(arch: str, args, run: RunConfig | None = None,
               zcfg: ZebraConfig | None = None,
               cfg: ModelConfig | None = None,
               return_state: bool = False, mesh=None) -> dict:
    """Train ``arch`` for ``args.steps`` steps under ``run``, ``zcfg`` and
    ``cfg`` (default: the driver's, see :func:`build`), with the
    command line's checkpoint and trace flags (the JAX driver's loop,
    repro/launch/train.py:95-170); returns a summary: the fitted zebra
    config (a dict, or None), ``start_step`` (the restored step, else 0),
    the metrics of each step run (floats), the wall time of each (host
    clock around work that ends in a device synchronize), ms/step
    (median), tokens/s, ``ok`` (every loss and grad norm finite), the
    checkpoint record (``ckpt``: each save's step, bytes, snapshot and
    write seconds; the restore's seconds and bytes) and the trace's
    (``trace``: event count, path). ``return_state``: the summary also
    holds the final params and optimizer state (``final_params``,
    ``final_opt_state``; on a mesh, this rank's blocks) and the program's
    ``layout``. ``mesh``: the mesh program (see :func:`build`);
    checkpoints are gathered to rank 0 and restored onto this mesh, and
    rank 0 alone traces."""
    cfg, program, loader = build(arch, args, run, zcfg, cfg, mesh)
    device = program.device
    layout = program.layout
    shard = {"shardings": layout.param_specs,
             "opt_shardings": layout.opt_specs}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ckpt = CheckpointManager(args.ckpt_dir, mesh=mesh) \
        if args.ckpt_dir else None
    start_step, restore = 0, None
    params = program.init_params(seed=0)
    opt_state = program.init_opt(params)
    if ckpt and args.resume and ckpt.latest_step() is not None:
        sync()
        t0 = time.perf_counter()
        start_step, params, opt_state, extra = ckpt.restore(
            params, opt_state, device=device, **shard)
        sync()
        restore = {"step": start_step, "s": time.perf_counter() - t0,
                   "bytes": sum(t.nbytes for t in
                                flatten({"p": params, "o": opt_state})
                                .values())}
        loader.load_state_dict(extra.get("loader", {"step": start_step}))
        print(f"[train] resumed from step {start_step}", flush=True)
        print(f"[train] restore: {restore['bytes']} bytes in "
              f"{restore['s'] * 1e3:.1f} ms", flush=True)
    loader.step = max(loader.step, start_step)

    n_params = sum(math.prod(s) for s in layout.shapes.values())
    zebra = dataclasses.asdict(program.zcfg) if program.zcfg else None
    shape = dict(mesh.shape) if mesh is not None else {"data": 1, "model": 1}
    print(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"mesh={shape} zebra={zebra} device={device}", flush=True)

    tracer = None
    last_logged: dict = {}
    if args.trace_out and (mesh is None or mesh.rank == 0):
        tracer = obs_trace.Tracer(wall=bool(args.trace_wall))
        obs_trace.install(tracer)
        tracer.declare_track("train", pid="train")
        tracer.registry.register("train", lambda: dict(last_logged))

    # modality-front stubs: the JAX driver's zero fronts at every step
    fronts = stack.zero_fronts(cfg, args.batch, program.run.policy
                               .compute_dtype, device)
    history, step_s = [], []
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        if tracer is not None:
            tracer.advance(step)
        batch = {**next(loader), **fronts}
        ts = time.perf_counter()
        with obs_trace.TRACER.span("train", f"step {step}", step=step):
            params, opt_state, metrics = program.train_step(
                params, opt_state, batch)
            sync()
        step_s.append(time.perf_counter() - ts)
        history.append({k: float(v) for k, v in metrics.items()})
        if (step + 1) % args.log_every == 0 or step == start_step:
            m = history[-1]
            dt = (time.perf_counter() - t0) / (step - start_step + 1)
            print(f"step {step + 1:5d} loss={m['loss']:.4f} "
                  f"nll={m['nll']:.4f} gnorm={m['grad_norm']:.3f} "
                  f"lr={m['lr']:.2e} {dt * 1e3:.0f} ms/step", flush=True)
            if tracer is not None:
                last_logged.update(step=step + 1, loss=m["loss"],
                                   nll=m["nll"],
                                   ms_per_step=round(dt * 1e3, 1))
                tracer.count("train", "loss", m["loss"])
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, params, opt_state,
                      extra={"loader": loader.state_dict()}, blocking=False,
                      **shard)
    if ckpt:
        ckpt.save(args.steps, params, opt_state,
                  extra={"loader": loader.state_dict()}, **shard)
        ckpt.wait()
        for rec in ckpt.saves:
            print(f"[train] ckpt: step {rec['step']} {rec['bytes']} bytes, "
                  f"snapshot {rec['snapshot_s'] * 1e3:.1f} ms, write "
                  f"{rec['write_s'] * 1e3:.1f} ms"
                  f"{'' if rec['blocking'] else ' (async)'}", flush=True)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        print(f"[train] ckpt: peak host RSS {rss} bytes", flush=True)
    trace = None
    if tracer is not None:
        if program.zcfg is not None:
            _lay_zebra_sim(tracer, cfg, args)
        obj = write_chrome_trace(tracer, args.trace_out)
        obs_trace.install(None)
        trace = {"events": len(obj["traceEvents"]), "path": args.trace_out}
        print(f"[train] trace: {trace['events']} events "
              f"-> {args.trace_out}", flush=True)
        for line in format_report(obj["reproIdle"]).splitlines():
            print(f"[train] idle: {line}", flush=True)
    ms = sorted(step_s)[len(step_s) // 2] * 1e3 if step_s else float("nan")
    ok = bool(history) and all(
        math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
        for m in history)
    final = history[-1]["loss"] if history else float("nan")
    print(f"[train] done: final loss {final:.4f}", flush=True)
    out = {"ok": ok, "arch": cfg.name, "device": str(device),
           "zebra": zebra, "params": n_params, "steps": args.steps,
           "start_step": start_step,
           "batch": args.batch, "seq": args.seq, "history": history,
           "step_s": step_s, "ms_per_step": ms,
           "tokens_per_s": args.batch * args.seq / (ms / 1e3),
           "ckpt": None if ckpt is None else {"saves": ckpt.saves,
                                               "restore": restore},
           "trace": trace}
    if return_state:
        out.update(final_params=params, final_opt_state=opt_state,
                   layout=layout)
    return out


def _lay_zebra_sim(tracer, cfg, args) -> None:
    """Lay the analytic zebra timeline (core.simulator over the canonical
    schedule, reference A40/V100 ZP pair) onto seconds-domain tracks next
    to the measured step clock, as the JAX driver does
    (repro/launch/train.py:173-195): the paper's own validation
    instrument, the per-stream / a2a-exposed breakdown of the modelled
    pair, not a reading of the card."""
    from repro_torch.core import hardware as HW
    from repro_torch.core import schedule as S
    from repro_torch.core.profiler import ZPGroupShape, profile_layer
    from repro_torch.core.simulator import CommTimes, simulate
    from repro_torch.obs.zebra import sim_to_trace

    zp = ZPGroupShape(M=1, N=1, attn_class=HW.A40, exp_class=HW.V100)
    link_bw = min(zp.attn_class.link_bw, zp.exp_class.link_bw)
    times = profile_layer(cfg, zp, args.batch, args.seq, args.microbatches,
                          link_bw=link_bw)
    sched = S.canonical_schedule(cfg.n_layers, args.microbatches,
                                 n_chunks=max(args.n_chunks, 1))
    res = simulate(sched, times, CommTimes(times.t_dispatch, times.t_combine),
                   cfg.n_experts, zp.N, zp.M)
    sim_to_trace(sched, res, tracer)
    print(f"[train] zebra-sim: iter={res.iter_time * 1e3:.2f} ms "
          f"attn_util={res.attn_util:.2f} exp_util={res.exp_util:.2f}",
          flush=True)


def _invalid(args, is_moe: bool) -> list:
    out = []
    if args.zebra and is_moe and args.zebra_mode not in MODES:
        out.append(f"--zebra-mode {args.zebra_mode} (replicated or "
                   f"alltoall)")
    if args.zebra and is_moe and args.microbatches < 1:
        out.append(f"--microbatches {args.microbatches} (at least 1)")
    try:
        parse_mesh(args.mesh)
    except ValueError:
        out.append(f"--mesh {args.mesh} (DxM, each at least 1)")
    return out


def _rank_main(rank: int, argv) -> None:
    """One rank of ``--mesh DxM`` (``launch_ranks`` target): rank 0
    prints, the others write nothing to stdout."""
    args = build_parser().parse_args(argv)
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    mesh = make_mesh(parse_mesh(args.mesh), ("data", "model"), args.device)
    summary = train_arch(args.arch, args, mesh=mesh)
    if not summary["ok"]:
        raise RuntimeError("a loss or grad norm is not finite")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="repro_torch training driver")
    ap.add_argument("--arch", default="mixtral-d2")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL ranks (one per card, or per CPU "
                         "rank with --device cpu)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; fails without a CUDA device) or "
                         "cpu (plain versions of the kernels)")
    ap.add_argument("--zebra", action="store_true", default=True,
                    help="zebra parallelism for MoE archs (default)")
    ap.add_argument("--no-zebra", dest="zebra", action="store_false")
    ap.add_argument("--zebra-mode", default="replicated",
                    help="replicated (default) or alltoall")
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--n-chunks", type=int, default=1,
                    help="capacity chunks for overlapped dispatch "
                         "(alltoall mode)")
    ap.add_argument("--offload-experts", type=int, default=0,
                    help="experts kept replicated attention-side "
                         "(alltoall mode Asym-EA offload)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data", default=None, help="token .bin (else synthetic)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the run "
                         "(obs §15; one tick per training step)")
    ap.add_argument("--trace-wall", action="store_true",
                    help="trace with wall-clock timestamps instead of the "
                         "deterministic step clock")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = registry.get_config(args.arch)
    invalid = _invalid(args, cfg.is_moe)
    if invalid:
        print("[train] invalid configuration: " + ", ".join(invalid),
              file=sys.stderr)
        return 1
    d, m = parse_mesh(args.mesh)
    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if d * m > 1 and d * m > have:
            print(f"[train] invalid configuration: --mesh {args.mesh} "
                  f"needs {d * m} CUDA devices; {have} present",
                  file=sys.stderr)
            return 1
        if not have:
            print("[train] no CUDA device: the port trains on the card; "
                  "pass --device cpu to run the plain versions on the CPU",
                  file=sys.stderr)
            return 2
    try:
        launch_ranks(_rank_main, d * m, args.device,
                     list(sys.argv[1:] if argv is None else argv))
    except Exception as e:  # a rank failed (spawned ranks: re-raised here)
        print(f"[train] FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
