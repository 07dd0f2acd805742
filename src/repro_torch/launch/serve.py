"""Continuous-batching serving driver of the port: Poisson arrivals, chunked
prefill into a paged KV pool, per-slot sampled decode, streaming
per-request output (mirror of ``repro/launch/serve.py``).

It takes the JAX driver's flags and builds the same Poisson trace
(``build_trace``, numpy only), so both packages serve identical requests.
It runs on the CUDA device unless ``--device cpu`` is given; without a
CUDA device and without ``--device cpu`` it exits non-zero.

    # the paper's Mixtral-W2 on the card, through the CUDA kernels:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-w2 \\
        --paged --page-size 16 --prefill-chunk 256 --prompt-len 384 \\
        --gen 32 --slots 4 --requests 6

    # smoke size on the CPU (plain versions of the kernels):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-w2 \\
        --smoke --paged --device cpu

Flags for deployment shapes the port does not serve yet (``--disagg``,
``--fleet``, ``--ep-size``, ``--prefix-cache``, ``--tenants``,
``--trace-out``, running without ``--paged``, ...) and archs with
recurrent mixers (``--arch mamba2-2.7b``: the engines' recurrent decode
state is not ported yet) are rejected by name in one ``[serve] invalid
configuration:`` line, exit 1.

Exit status: non-zero when any request is rejected or left unfinished,
when the configuration is invalid, or when the device is missing.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.serve import (Request, SamplingParams, ServeConfig,
                               ServeConfigError, ServeMetrics,
                               build_deployment)

SMOKE_ARCHS = ("qwen3-moe-30b-a3b", "llama3.2-3b")  # MoE + dense


def build_trace(seed: int, n: int, rate: float, prompt_len: int, gen: int,
                vocab: int, sampling: SamplingParams,
                eos_token=None) -> list:
    """Mixed-length Poisson trace: exponential inter-arrivals (in engine
    ticks), prompt lengths in [prompt_len/4, prompt_len], generation
    budgets in [gen/2, gen]. The JAX driver's generator, draw for draw."""
    rng = np.random.RandomState(seed)
    t, reqs = 0.0, []
    for i in range(n):
        t += rng.exponential(1.0 / rate)
        plen = int(rng.randint(max(1, prompt_len // 4), prompt_len + 1))
        gmax = int(rng.randint(max(1, gen // 2), gen + 1))
        prompt = rng.randint(0, vocab, size=(plen,)).astype(int).tolist()
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gmax,
                            sampling=sampling, eos_token=eos_token,
                            arrival=t))
    return reqs


def serve_arch(arch: str, args, serve_cfg: ServeConfig = None) -> dict:
    """Serve the trace of ``args`` on ``arch``; returns the metrics summary
    with ``ok`` (every request finished with its full budget, nothing
    rejected, the allocator's page accounting clean)."""
    cfg = registry.get_config(arch)
    if args.smoke:
        cfg = registry.smoke_config(cfg)
    run = RunConfig(policy=Policy(), moe_impl="gather")
    if serve_cfg is None:
        serve_cfg = ServeConfig.from_args(args)
    try:
        serve_cfg.validate(model_cfg=cfg)
    except ServeConfigError as e:
        print(f"[serve] FAIL arch={cfg.name}: invalid serve config: {e}",
              file=sys.stderr)
        return {"ok": False, "n_requests": 0, "config_error": str(e)}
    trace = build_trace(args.seed, args.requests, args.rate, args.prompt_len,
                        args.gen, cfg.vocab_size, serve_cfg.sampling)
    metrics = ServeMetrics()
    stream = None
    if args.stream:
        def stream(rid, tok, fin):
            print(f"[{cfg.name}] rid={rid} tok={tok}"
                  + (" <done>" if fin else ""))

    engine = build_deployment(cfg, run, serve_cfg, device=args.device,
                              metrics=metrics, on_token=stream)
    t0 = time.perf_counter()
    results = engine.run(trace)
    dt = time.perf_counter() - t0

    for req in trace:
        tr = metrics.requests.get(req.rid)
        if tr is None:  # rejected at submit — never entered the engine
            print(f"[{cfg.name}] rid={req.rid} prompt={len(req.prompt)} "
                  f"REJECTED")
            continue
        toks = results[req.rid]
        print(f"[{cfg.name}] rid={req.rid} prompt={len(req.prompt)} "
              f"gen={len(toks)}/{req.max_new_tokens} "
              f"first_tick={tr.first_token_tick} "
              f"finish_tick={tr.finish_tick} out={toks[:8]}...")
    s = metrics.summary()
    print(f"[serve] arch={cfg.name} device={args.device} "
          f"{s['n_requests']} requests, "
          f"{s['n_generated_tokens']} tokens in {dt:.2f}s "
          f"({s['tokens_per_s']} tok/s, ttft p50 {s['ttft_s']['p50']:.3f}s, "
          f"itl p50 {s['itl_s']['p50']:.4f}s, "
          f"queue depth max {s['queue_depth']['max']}, "
          f"max concurrent {s['max_concurrent_active']})")
    s["paged"] = occ = engine.page_occupancy()
    print(f"[serve] arch={cfg.name} paged: "
          f"page_size={serve_cfg.paged.page_size} "
          f"pool={engine.p.n_pages} peak={occ['page_peak']} "
          f"preempted={occ['n_preempted']}")
    engine.sched.allocator.check()
    # Gate: every traced request must finish with its full token budget
    # (traces carry no EOS) and nothing may be rejected.
    unfinished = [r.rid for r in trace
                  if metrics.requests.get(r.rid) is None
                  or metrics.requests[r.rid].finish_tick is None
                  or len(results.get(r.rid, [])) != r.max_new_tokens]
    s["ok"] = not engine.rejected and not unfinished \
        and s["n_requests"] == len(trace)
    if not s["ok"]:
        print(f"[serve] FAIL arch={cfg.name}: rejected={engine.rejected} "
              f"unfinished={unfinished} finished={s['n_requests']}"
              f"/{len(trace)}", file=sys.stderr)
    return s


# The JAX driver's flags for deployment shapes the port does not serve yet
# (prefix cache, tenants, disaggregation, fleet, chaos, expert-parallel
# decode, tracing, device meshes): accepted, so that a command line written
# for the JAX driver is rejected by name instead of by argparse.
_UNPORTED_SWITCHES = ("--prefix-cache", "--fair", "--disagg", "--fleet",
                      "--fleet-elastic", "--trace-wall")
_UNPORTED_VALUES = (("--prefix-capacity", int), ("--tenants", int),
                    ("--shared-prefix-len", int),
                    ("--prefill-pool-pages", int), ("--prefill-groups", str),
                    ("--decode-groups", str), ("--kill-group", str),
                    ("--chaos", str), ("--chaos-seed", int),
                    ("--slo-ttft", float), ("--ep-size", int),
                    ("--ep-placement", str), ("--trace-out", str))


def _unported_flags(args) -> list:
    """The unported flags set on this command line (0 / off values, which
    the JAX driver also reads as "off", pass), a mesh other than one
    device, and an arch with recurrent mixers (the engines hold attention
    caches only)."""
    flags = list(_UNPORTED_SWITCHES) + [f for f, _ in _UNPORTED_VALUES]
    out = [f for f in flags
           if getattr(args, f[2:].replace("-", "_")) not in (None, False, 0)]
    if args.mesh != "1x1":
        out.append(f"--mesh {args.mesh} (one device only)")
    if args.arch is not None:
        cfg = registry.get_config(args.arch)
        rec = sorted({s.mixer for s in (*cfg.pattern, *cfg.tail_specs)
                      if s.mixer in ("ssd", "rglru")})
        if rec:
            out.append(f"--arch {args.arch} (recurrent {'/'.join(rec)} "
                       f"mixers: their decode state is not ported yet)")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="repro_torch continuous-batching serving driver")
    ap.add_argument("--arch", default=None,
                    help="default: llama3.2-3b; with --smoke and no --arch, "
                         "runs the MoE + dense smoke pair")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; fails without a CUDA device) or "
                         "cpu (plain versions of the kernels)")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent KV slots (decode batch)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--rate", type=float, default=0.4,
                    help="Poisson arrival rate (requests per engine tick)")
    ap.add_argument("--prompt-len", type=int, default=48,
                    help="max prompt length (trace mixes lengths below it)")
    ap.add_argument("--gen", type=int, default=24,
                    help="max new tokens (trace mixes budgets below it)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="prefill tokens per tick (default: one chunk)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are generated")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (block allocator + page-table "
                         "decode, DESIGN.md §9); required by the port")
    ap.add_argument("--page-size", type=int, default=16,
                    help="cache lines per page (paged mode)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="physical pool size in pages (default: full "
                         "reservation capacity; smaller values overcommit "
                         "and exercise preemption)")
    ap.add_argument("--mesh", default="1x1", help="1x1 only")
    for flag in _UNPORTED_SWITCHES:
        ap.add_argument(flag, action="store_true", help="not ported yet")
    for flag, typ in _UNPORTED_VALUES:
        ap.add_argument(flag, type=typ, default=None, help="not ported yet")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    errs = []
    unported = _unported_flags(args)
    if unported:
        errs.append("not ported to repro_torch yet: " + ", ".join(unported))
    try:
        ServeConfig.from_args(args).validate()
    except ServeConfigError as e:
        errs.append(str(e))
    if errs:
        print(f"[serve] invalid configuration: {'; '.join(errs)}",
              file=sys.stderr)
        return 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[serve] no CUDA device: the port serves on the card; pass "
              "--device cpu to run the plain versions on the CPU",
              file=sys.stderr)
        return 2
    archs = [args.arch] if args.arch else \
        (list(SMOKE_ARCHS) if args.smoke else ["llama3.2-3b"])
    failed = [arch for arch in archs if not serve_arch(arch, args)["ok"]]
    if failed:
        print(f"[serve] FAILED archs: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
