"""Continuous-batching serving driver of the port: Poisson arrivals, chunked
prefill, per-slot sampled decode, streaming per-request output (mirror of
``repro/launch/serve.py``).

It takes the JAX driver's flags and builds the same Poisson trace
(``build_trace``, numpy only), so both packages serve identical requests.
It runs on the CUDA device unless ``--device cpu`` is given; without a
CUDA device and without ``--device cpu`` it exits non-zero.

    # the paper's Mixtral-W2 on the card, through the CUDA kernels:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-w2 \\
        --paged --page-size 16 --prefill-chunk 256 --prompt-len 384 \\
        --gen 32 --slots 4 --requests 6

    # smoke size on the CPU (plain versions of the kernels); without
    # --paged the dense per-slot KV caches, the JAX driver's default:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-w2 \\
        --smoke --paged --device cpu

    # prefix-cached copy-on-write paged KV over a shared-prefix
    # multi-tenant trace (DESIGN.md §14); --fair switches admission to
    # per-tenant deficit round-robin:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-w2 \\
        --smoke --paged --prefix-cache --tenants 2 --fair --requests 8 \\
        --device cpu

    # disaggregated prefill/decode (role-split workers, page-id KV
    # handoff, DESIGN.md §10); a tight decode pool exercises the
    # preempt -> re-prefill path; --trace-out writes a Perfetto trace:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-w2 \\
        --smoke --disagg --page-size 16 --pool-pages 12 \\
        --trace-out build/serve_trace.json --device cpu

    # the elastic fleet (DESIGN.md §12): 2 prefill + 2 decode groups (the
    # classes set the router's speed priors; every group computes on the
    # one device), role flips, a crash of group 2 at tick 10 recovered by
    # token-exact re-prefill, and a seeded chaos schedule (§13):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-w2 \\
        --smoke --fleet --prefill-groups a40,a40 --decode-groups v100,v100 \\
        --fleet-elastic --kill-group 2@10 --chaos 'drop%0.5*2;stall*1' \\
        --chaos-seed 7 --device cpu

    # expert-parallel decode (DESIGN.md §11) at one EP rank: the experts
    # stored in placement order with an expert -> slot map, every MoE FFN
    # through the chunked all-to-all hop (the identity at one rank), the
    # routing EMA fed every decode step; planned re-places experts online
    # when it drifts. Also without --paged, and with --disagg:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-w2 \\
        --smoke --paged --ep-size 1 --ep-placement planned --device cpu

``--ep-size`` N needs N EP ranks: the driver runs one (the JAX driver's
1x1 mesh), so N > 1 fails the JAX validation message ("bad EP config:
ep_size N != mesh axis 'model' size 1"), exit 1; two or more ranks run
through ``build_deployment(ep_group=)`` on a ``torch.distributed`` group.
Archs with recurrent mixers (``--arch recurrentgemma-9b``, ``--arch
mamba2-2.7b``) serve in every mode but the prefix cache, as in the JAX
driver: each slot carries its RG-LRU or SSD state beside the attention
caches. The encoder-decoder and vision archs (``--arch whisper-tiny``,
``--arch llama-3.2-vision-90b``) take the JAX driver's lockstep fallback
(:func:`serve_arch_lockstep`: ``--slots`` prompts of ``--prompt-len``
tokens, ``--gen`` greedy tokens each, zero front embeddings), whatever
``--paged``, ``--disagg`` or ``--fleet`` ask:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --smoke --device cpu

A ``--mesh`` other than 1x1 is rejected by name in one ``[serve]
invalid configuration:`` line, exit 1 (the serving mesh, the ``serve``
sharding rules over ``launch.mesh``, is not ported yet; the training
mesh is, ``launch/train.py --mesh``), as are the JAX driver's own invalid
combinations (``--fleet`` with ``--disagg`` or ``--ep-size``, ``--chaos``
without ``--fleet``, ``--prefix-cache`` on a recurrent arch, ...), with its
messages.

Exit status: non-zero when any request is rejected, dropped or left
unfinished, when a fleet stalls or a surviving pool leaks pages under
chaos, when the configuration is invalid, or when the device is missing.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core.zebra_spmd import EPGroup
from repro_torch.models import registry, stack
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.obs import format_report, write_chrome_trace
from repro_torch.obs import trace as obs_trace
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


def build_tenant_trace(args, vocab: int, sampling: SamplingParams) -> list:
    """Shared-prefix multi-tenant trace (--tenants N, DESIGN.md §14):
    same-tenant requests share a seeded system prefix, which is what the
    prefix cache and the fairness admission are exercised against. The
    JAX driver's generator (``core.simulator.multi_tenant_trace``)."""
    from repro_torch.core.simulator import multi_tenant_trace
    recs = multi_tenant_trace(
        args.seed, args.requests, n_tenants=args.tenants, rate=args.rate,
        prompt_len=args.prompt_len, gen=args.gen, vocab=vocab,
        shared_len=args.shared_prefix_len)
    return [Request(rid=i, prompt=list(r.prompt), max_new_tokens=r.gen,
                    sampling=sampling, arrival=r.arrival, tenant=r.tenant)
            for i, r in enumerate(recs)]


def _prefix_summary(index, alloc, n_prefix_hits: int,
                    tokens_skipped: int) -> dict:
    """The summary's ``prefix`` section: index + allocator accounting."""
    return {
        "lookups_hit": index.hits,
        "lookups_miss": index.misses,
        "tokens_served": index.tokens_served,
        "admissions_hit": n_prefix_hits,
        "tokens_skipped": tokens_skipped,
        "pages_pinned": index.n_pages,
        "pages_evicted": index.n_evicted,
        "pages_allocated": alloc.n_fresh_allocs,
        "pages_shared": alloc.n_shared_allocs,
        "n_cow_forks": alloc.n_cow_forks,
    }


def _disagg_summary(engine, page_size: int) -> dict:
    """The summary's ``disagg`` section: pools, transfers, preemptions."""
    st = engine.transfer.stats
    return {
        "page_size": page_size,
        "decode_pages": engine.decode.allocator.n_pages,
        "prefill_pages": engine.prefill.allocator.n_pages,
        "decode_page_peak": engine.decode.page_peak,
        "n_preempted": engine.decode.sched.n_preempted,
        "kv_transfers": st.n_transfers,
        "kv_pages_shipped": st.n_pages,
        "kv_bytes_shipped": st.bytes,
        "prefix_full_hits": engine.n_full_hits,
    }


def _fleet_summary(engine, serve_cfg: ServeConfig) -> dict:
    """The summary's ``fleet`` section: groups, events, flips, transfers."""
    st = engine.transfer.stats
    return {
        "elastic": serve_cfg.fleet.elastic,
        "ticks": engine.tick_count,
        "groups": [{"gid": g.gid, "cls": g.cls, "role": g.role,
                    "flips": g.flips} for g in engine.groups],
        "events": [{"tick": e.tick, "kind": e.kind, "gid": e.gid,
                    "detail": e.detail} for e in engine.events],
        "n_flips": engine.n_flips,
        "n_killed": len([e for e in engine.events if e.kind == "dead"]),
        "kv_transfers": st.n_transfers,
        "kv_pages_shipped": st.n_pages,
    }


def _ep_summary(engine, serve_cfg: ServeConfig) -> dict:
    """The summary's ``ep`` section, the JAX driver's keys. The JAX
    driver prints it for the unified engines; the disaggregated one, which
    places its experts once and never re-balances, reports its decode
    worker's routing EMA here too."""
    if serve_cfg.disagg.enabled:
        n_rebalances, ema = 0, engine.decode.routing_ema
    else:
        n_rebalances, ema = engine.n_rebalances, engine.ema
    return {"ep_size": serve_cfg.ep.ep_size,
            "placement_mode": serve_cfg.ep.placement,
            "n_rebalances": n_rebalances,
            "ema_updates": ema.n_updates}


def _chaos_summary(engine, serve_cfg: ServeConfig, shed: set,
                   leaked: list) -> dict:
    """The summary's ``chaos`` section: the replayable fault log, its
    signature, the robustness counters, shed requests, leaking groups."""
    chaos = engine.chaos
    return {
        "spec": serve_cfg.chaos.spec,
        "seed": serve_cfg.chaos.seed,
        "events": chaos.log(),
        "signature": chaos.log_signature(),
        "counters": engine.metrics.robust.as_dict(),
        "n_shed": len(shed),
        "leaked_groups": leaked,
    }


def serve_arch_lockstep(cfg, run, serve_cfg: ServeConfig, args, *,
                        params=None, fronts=None) -> dict:
    """Whole-batch lockstep fallback for encoder-decoder and vision archs
    (the JAX driver's ``serve_arch_lockstep``: they need per-request front
    embeddings that the continuous engines do not carry): ``--slots``
    prompts of ``--prompt-len`` tokens drawn from
    ``numpy.random.RandomState(--seed)``, prefill, then ``--gen`` - 1
    greedy decode steps, each rebuilding the cross-attention memory from
    the fronts. ``fronts`` defaults to the driver's zero fronts
    (``stack.zero_fronts``). Returns the JAX driver's keys
    (``tokens_per_s``, ``lockstep``, ``ok``) and the tokens generated, the
    prefill's wall time (``ttft_s``) and each decode step's (``itl_s``),
    each read after a device synchronize."""
    server = build_deployment(cfg, run, serve_cfg, params=params,
                              device=args.device)
    slots, gen = serve_cfg.slots, args.gen
    dev = server.p.device
    prompts = np.random.RandomState(serve_cfg.seed).randint(
        0, cfg.vocab_size, (slots, args.prompt_len))
    if fronts is None:
        fronts = stack.zero_fronts(cfg, slots, run.policy.compute_dtype,
                                   dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    out = [server.submit_prefill(prompts, fronts)]
    sync()
    ttft = time.perf_counter() - t0
    itl = []
    for _ in range(gen - 1):
        ts = time.perf_counter()
        out.append(server.step(fronts))
        sync()
        itl.append(time.perf_counter() - ts)
    toks = torch.cat(out, dim=1)
    dt = time.perf_counter() - t0
    tps = round(slots * gen / dt, 2)
    print(f"[serve] arch={cfg.name} lockstep fallback generated "
          f"{tuple(toks.shape)} in {dt:.2f}s ({tps} tok/s)")
    return {"tokens_per_s": tps, "lockstep": True,
            "ok": tuple(toks.shape) == (slots, gen),
            "n_generated_tokens": slots * gen, "tokens": toks.tolist(),
            "ttft_s": ttft, "itl_s": itl}


def serve_arch(arch: str, args, serve_cfg: ServeConfig = None, *,
               trace=None, params=None, run=None,
               engine_hook=None, fronts=None, cfg=None) -> dict:
    """Serve the trace of ``args`` on ``arch``; returns the metrics summary
    with ``ok`` (every request finished with its full budget or was shed,
    nothing rejected, the allocators' page accounting clean, no surviving
    fleet pool holding pages under chaos) and the deployment's sections
    (``paged``, ``prefix``, ``disagg``, ``fleet``, ``chaos``, ``trace``).

    The keywords are for callers that drive the deployment themselves (the
    chip smoke test): ``trace`` replaces the trace built from ``args``,
    ``params`` and ``run`` the seed-0 init and the bf16 policy, and
    ``engine_hook(engine)`` is handed the built deployment before the
    trace runs; ``cfg`` replaces the registry's config of ``arch`` (a
    caller's cut of its depth). The encoder-decoder and vision archs serve
    lockstep (:func:`serve_arch_lockstep`, which takes ``params`` and
    ``fronts``, their front embeddings)."""
    if cfg is None:
        cfg = registry.get_config(arch)
        if args.smoke:
            cfg = registry.smoke_config(cfg)
    if run is None:
        run = RunConfig(policy=Policy(), moe_impl="gather")
    if serve_cfg is None:
        serve_cfg = ServeConfig.from_args(args)
    try:
        # the EP ranks of this driver: one (the JAX driver's 1x1 mesh)
        serve_cfg.validate(model_cfg=cfg, ep_group=EPGroup())
    except ServeConfigError as e:
        print(f"[serve] FAIL arch={cfg.name}: invalid serve config: {e}",
              file=sys.stderr)
        return {"ok": False, "n_requests": 0, "config_error": str(e)}
    if cfg.is_encdec or cfg.vision_seq > 0:
        return serve_arch_lockstep(cfg, run, serve_cfg, args, params=params,
                                   fronts=fronts)
    sampling = serve_cfg.sampling
    if trace is None:
        if args.tenants:
            trace = build_tenant_trace(args, cfg.vocab_size, sampling)
        else:
            trace = build_trace(args.seed, args.requests, args.rate,
                                args.prompt_len, args.gen, cfg.vocab_size,
                                sampling)
    metrics = ServeMetrics()
    stream = None
    if args.stream:
        def stream(rid, tok, fin):
            print(f"[{cfg.name}] rid={rid} tok={tok}"
                  + (" <done>" if fin else ""))

    trace_out = args.trace_out
    tracer = None
    if trace_out:
        # Tick-clock tracing (DESIGN.md §15): installed process-wide so
        # every instrumented hot path emits; off by default (NullTracer).
        tracer = obs_trace.Tracer(wall=bool(args.trace_wall))
        obs_trace.install(tracer)
    try:
        engine = build_deployment(cfg, run, serve_cfg, params=params,
                                  device=args.device, metrics=metrics,
                                  on_token=stream)
    except ValueError as e:
        # Anything validate() could not see statically still fails the
        # run, never half-serves.
        print(f"[serve] FAIL arch={cfg.name}: bad deployment: {e}",
              file=sys.stderr)
        obs_trace.install(None)
        return {"ok": False, "n_requests": 0, "config_error": str(e)}
    if tracer is not None:
        # Unified counters registry: the exporter snapshots these into the
        # trace artifact's reproCounters section.
        tracer.registry.register("serve", metrics.summary)
        tracer.registry.register("robust", metrics.robust.as_dict)
    if engine_hook is not None:
        engine_hook(engine)

    shed: set = set()
    leaked: list = []
    t0 = time.perf_counter()
    if serve_cfg.fleet.enabled:
        try:
            results = engine.run(trace, kills=list(serve_cfg.fleet.kills))
        except RuntimeError as e:
            # A wedged fleet (the only decode group killed without
            # --fleet-elastic) would drop requests: fail the run.
            print(f"[serve] FAIL arch={cfg.name}: fleet stalled: {e}",
                  file=sys.stderr)
            obs_trace.install(None)
            return {"ok": False, "n_requests": 0, "fleet_error": str(e)}
        shed = set(engine.shed)
    else:
        results = engine.run(trace)
    dt = time.perf_counter() - t0

    for req in trace:
        if req.rid in shed:  # an explicit SLO-shed outcome
            print(f"[{cfg.name}] rid={req.rid} prompt={len(req.prompt)} "
                  f"SHED")
            continue
        tr = metrics.requests.get(req.rid)
        if tr is None:  # rejected at submit — never entered the engine
            print(f"[{cfg.name}] rid={req.rid} prompt={len(req.prompt)} "
                  f"REJECTED")
            continue
        toks = results[req.rid]
        tenant = f" tenant={req.tenant}" if args.tenants else ""
        print(f"[{cfg.name}] rid={req.rid}{tenant} "
              f"prompt={len(req.prompt)} "
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
    if serve_cfg.fleet.enabled:
        # Surviving pools hold the exactly-once page invariant after
        # kills, recoveries and flips; under chaos a drained fleet holds
        # ZERO pages on every surviving pool (a leftover page is a leak
        # the fault path failed to roll back).
        for g in engine.groups:
            g.worker.allocator.check()
        if engine.chaos is not None:
            leaked = [g.gid for g in engine.groups
                      if g.worker.allocator.pages_in_use != 0]
        st = engine.transfer.stats
        s["fleet"] = _fleet_summary(engine, serve_cfg)
        if engine.chaos is not None:
            s["chaos"] = _chaos_summary(engine, serve_cfg, shed, leaked)
            print(f"[serve] arch={cfg.name} chaos: "
                  f"spec={serve_cfg.chaos.spec!r} "
                  f"seed={serve_cfg.chaos.seed} "
                  f"faults={len(engine.chaos.log())} "
                  f"sig={engine.chaos.log_signature()} shed={len(shed)} "
                  f"retries={st.n_retries} aborts={st.n_aborts} "
                  f"fenced={metrics.robust.fenced_stale_completions}")
        roles = ",".join(f"g{g.gid}={g.cls}:{g.role}"
                         for g in engine.groups)
        print(f"[serve] arch={cfg.name} fleet: {roles} "
              f"flips={engine.n_flips} "
              f"events={len(engine.events)} transfers={st.n_transfers} "
              f"ttft_p99={s['ttft_s']['p99']:.3f}s "
              f"itl_p99={s['itl_s']['p99']:.4f}s")
    elif serve_cfg.disagg.enabled:
        st = engine.transfer.stats
        s["disagg"] = _disagg_summary(engine, serve_cfg.paged.page_size)
        print(f"[serve] arch={cfg.name} disagg: "
              f"page_size={serve_cfg.paged.page_size} "
              f"transfers={st.n_transfers} pages={st.n_pages} "
              f"preempted={engine.decode.sched.n_preempted} "
              f"full_hits={engine.n_full_hits}")
        index = engine.decode.sched.prefix_index
        if index is not None:
            s["prefix"] = _prefix_summary(
                index, engine.decode.allocator,
                engine.prefill.sched.n_prefix_hits,
                engine.prefill.sched.n_tokens_skipped)
            s["prefix"]["full_hits"] = engine.n_full_hits
            index.check()
        engine.prefill.allocator.check()
        engine.decode.allocator.check()
    elif serve_cfg.paged.enabled:
        s["paged"] = occ = engine.page_occupancy()
        print(f"[serve] arch={cfg.name} paged: "
              f"page_size={serve_cfg.paged.page_size} "
              f"pool={engine.p.n_pages} peak={occ['page_peak']} "
              f"preempted={occ['n_preempted']}")
        index = engine.sched.prefix_index
        if index is not None:
            s["prefix"] = _prefix_summary(
                index, engine.sched.allocator,
                engine.sched.prefill.n_prefix_hits,
                engine.sched.prefill.n_tokens_skipped)
            print(f"[serve] arch={cfg.name} prefix: "
                  f"hits={index.hits} tokens_served={index.tokens_served} "
                  f"skipped={engine.sched.prefill.n_tokens_skipped} "
                  f"cow_forks={engine.sched.allocator.n_cow_forks} "
                  f"pinned={index.n_pages}")
            index.check()
        engine.sched.allocator.check()
    if serve_cfg.ep.ep_size and not serve_cfg.fleet.enabled:
        s["ep"] = _ep_summary(engine, serve_cfg)
        print(f"[serve] arch={cfg.name} ep: "
              f"ep_size={serve_cfg.ep.ep_size} "
              f"placement={serve_cfg.ep.placement} "
              f"rebalances={s['ep']['n_rebalances']} "
              f"ema_updates={s['ep']['ema_updates']}")
    # Gate: every traced request must finish with its full token budget
    # (traces carry no EOS) and nothing may be rejected. Shed requests
    # (SLO admission) are an explicit outcome, excluded from the finish
    # requirement.
    unfinished = [r.rid for r in trace
                  if r.rid not in shed
                  and (metrics.requests.get(r.rid) is None
                       or metrics.requests[r.rid].finish_tick is None
                       or len(results.get(r.rid, [])) != r.max_new_tokens)]
    if tracer is not None:
        obj = write_chrome_trace(tracer, trace_out, ticks=engine.tick_count)
        obs_trace.install(None)
        print(f"[serve] arch={cfg.name} trace: "
              f"{len(obj['traceEvents'])} events -> {trace_out}")
        for line in format_report(obj["reproIdle"]).splitlines():
            print(f"[serve] idle: {line}")
        s["trace"] = {"path": trace_out,
                      "n_events": len(obj["traceEvents"])}
    s["ok"] = not engine.rejected and not unfinished and not leaked \
        and s["n_requests"] == len(trace) - len(shed)
    if not s["ok"]:
        print(f"[serve] FAIL arch={cfg.name}: rejected={engine.rejected} "
              f"unfinished={unfinished} leaked={leaked} "
              f"finished={s['n_requests']}/{len(trace) - len(shed)}",
              file=sys.stderr)
    return s


def _unported_flags(args) -> list:
    """What this command line asks that the port does not serve yet: a
    mesh other than one device (the serving mesh)."""
    if args.mesh != "1x1":
        return [f"--mesh {args.mesh} (the serving mesh is not ported; "
                f"one device only)"]
    return []


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
                         "decode, DESIGN.md §9); without it, dense "
                         "per-slot KV caches")
    ap.add_argument("--page-size", type=int, default=16,
                    help="cache lines per page (paged mode)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="physical pool size in pages (default: full "
                         "reservation capacity; smaller values overcommit "
                         "and exercise preemption)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="prefix-cached copy-on-write paged KV (DESIGN.md "
                         "§14): cached prompt prefixes mount as shared "
                         "pages and skip prefill; needs --paged or "
                         "--disagg")
    ap.add_argument("--prefix-capacity", type=int, default=None,
                    metavar="PAGES",
                    help="LRU bound on pages the prefix index may pin "
                         "(default: unbounded — allocator pressure is "
                         "the only bound)")
    ap.add_argument("--fair", action="store_true",
                    help="per-tenant deficit round-robin admission "
                         "(DESIGN.md §14): a flooding tenant cannot "
                         "starve the rest")
    ap.add_argument("--tenants", type=int, default=0,
                    help="build a shared-prefix multi-tenant trace with "
                         "this many tenants (0: classic mixed-length "
                         "Poisson trace)")
    ap.add_argument("--shared-prefix-len", type=int, default=None,
                    help="tenant shared-prefix length in tokens "
                         "(default: half of --prompt-len)")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode deployment "
                         "(DESIGN.md §10): role-split workers over "
                         "separate paged pools, KV handed off as pages; "
                         "--pool-pages sizes the decode pool")
    ap.add_argument("--prefill-pool-pages", type=int, default=None,
                    help="prefill-side pool size in pages (disagg and "
                         "fleet modes; default: two max-length sequences)")
    ap.add_argument("--fleet", action="store_true",
                    help="elastic multi-group fleet (DESIGN.md §12): "
                         "N prefill + M decode groups of mixed device "
                         "classes behind a router, heartbeat failure "
                         "recovery; see --prefill-groups/--decode-groups")
    ap.add_argument("--prefill-groups", default="a40",
                    help="fleet prefill groups: an integer count or a "
                         "comma-separated device-class list, e.g. "
                         "'a40,a40' or '2' (default one a40 group); the "
                         "class sets the router's speed prior")
    ap.add_argument("--decode-groups", default="v100",
                    help="fleet decode groups: an integer count or a "
                         "comma-separated device-class list, e.g. "
                         "'v100,v100' (default one v100 group)")
    ap.add_argument("--fleet-elastic", action="store_true",
                    help="enable elastic role reassignment: idle groups "
                         "flip prefill<->decode when the bottleneck "
                         "role shifts or a role dies out")
    ap.add_argument("--kill-group", action="append", metavar="GID@TICK",
                    help="fault injection (repeatable): crash fleet group "
                         "GID at the start of tick TICK — sugar for a "
                         "crash_start@TICK:gGID entry of the ft.chaos "
                         "grammar (the full entry form is also accepted)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="seeded fault schedule (fleet mode, DESIGN.md "
                         "§13): ';'-joined ft.chaos entries "
                         "SITE[@TICK][:TARGET][%%PROB][*COUNT][~DURATION] "
                         "— e.g. 'drop%%0.6*4;hb_loss@6:g3~8'; malformed "
                         "specs exit non-zero")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the chaos injector: the same "
                         "(seed, spec) replays the identical fault log")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="SLO-aware admission (fleet mode): shed arrivals "
                         "whose best prefill ETA exceeds this many "
                         "seconds of estimated work")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto/Chrome trace-event JSON of the "
                         "run (tick-clock spans, request flows, counters, "
                         "idle-time attribution — DESIGN.md §15); tracing "
                         "is fully off without this flag")
    ap.add_argument("--trace-wall", action="store_true",
                    help="annotate trace spans with wall-clock readings "
                         "(opt-in; excluded from the deterministic trace "
                         "signature)")
    ap.add_argument("--ep-size", type=int, default=0,
                    help="shard MoE expert weights across this many EP "
                         "ranks for decode (DESIGN.md §11); must divide the "
                         "expert count, needs a MoE --arch and equals the "
                         "driver's one rank (a mesh 'model' axis of 1): "
                         "rejected otherwise, never truncated; 0 = off")
    ap.add_argument("--ep-placement", choices=("uniform", "planned"),
                    default="uniform",
                    help="uniform: static round-robin expert placement; "
                         "planned: online heterogeneity-aware re-placement "
                         "from the observed routing EMA")
    ap.add_argument("--mesh", default="1x1",
                    help="1x1 only (the serving mesh is not ported)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    errs = []
    unported = _unported_flags(args)
    if unported:
        errs.append("not ported to repro_torch yet: " + ", ".join(unported))
    try:
        ServeConfig.from_args(args).validate(
            model_cfg=registry.get_config(args.arch) if args.arch else None,
            ep_group=EPGroup())
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
    failed = []
    trace_out = args.trace_out
    for arch in archs:
        if trace_out and len(archs) > 1:
            # One artifact per arch (the smoke pair would overwrite).
            stem, dot, ext = trace_out.rpartition(".")
            args.trace_out = f"{stem}.{arch}.{ext}" if dot \
                else f"{trace_out}.{arch}"
        if not serve_arch(arch, args)["ok"]:
            failed.append(arch)
    if failed:
        print(f"[serve] FAILED archs: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
