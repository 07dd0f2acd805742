#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA device:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, serves a
Poisson trace on the full-width ``mixtral-w2`` (4 layers, d_model 2048, 24
experts top-2, random weights from seed 0) through the port's own driver
(``repro_torch.launch.serve``) with the paged engine, and fails unless:

* every request finishes with its full budget and the page allocator's
  accounting is clean;
* each kernel of that path was launched during the serve run (launch
  counters set to 0 just before it and read just after);
* each kernel agrees with its plain PyTorch version on the card, at the
  serve run's shapes, within 2e-2 * min(1, max|plain|) (bf16: 2e-2 where
  the outputs reach 1, less where they stay smaller), taken per decode
  slot for paged decode so that a long slot's small outputs are held at
  their own size;
* under the f32 policy, the paged engine's first-token logits of the
  trace's first request whose prompt spans several prefill chunks match
  the cache-free forward's within 1e-3 * max|logit|.

One untimed warm-up request (its own engine, launches not counted) runs
before the timed serve run, so that one-time costs (library handles,
allocator growth) stay out of the timed window.

Printed in order: the device line (torch's name and nvidia-smi's name and
power limit), the kernel build time, the warm-up run's lines, the serve
run's lines, the kernel tolerances, the ``kernels`` JSON line, the serve line,
the parity line, and last
``{"ok": true, "device": {"platform": "gpu", ...}}``. Without a CUDA device,
or without the repository beside it, it exits non-zero and prints no result.
Details (nvcc register reports, the full result) go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SERVE_ARGS = ["--arch", "mixtral-w2", "--paged", "--page-size", "16",
              "--prefill-chunk", "256", "--prompt-len", "384", "--gen", "32",
              "--slots", "4", "--requests", "6"]
WARMUP_ARGS = SERVE_ARGS + ["--requests", "1", "--gen", "4"]  # last wins
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
TOL_BF16 = 2e-2             # the bf16 tier of tests/test_kernels.py:40
PARITY_REL = 1e-3


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, per_row: bool = False):
    """(max abs error, tolerance, ok): 2e-2 scaled down to the outputs'
    size where they stay below 1, never looser than 2e-2. ``per_row``
    scales it to each row of the leading axis (each decode slot) on its
    own; the tolerance reported is then the tightest row's."""
    diff = (got.float() - want.float()).abs()
    size = want.float().abs()
    if per_row:
        dims = tuple(range(1, diff.dim()))
        err, top = diff.amax(dims), size.amax(dims)
    else:
        err, top = diff.max()[None], size.max()[None]
    tol = TOL_BF16 * top.clamp(max=1.0)
    return (float(err.max()), float(tol.min()), bool((err <= tol).all()))


def check_gmm_kernels(torch, cfg, launches):
    """Fused GLU and down GEMM at the serve run's prefill-chunk shapes: a
    256-token chunk routed top-2 over the experts (M = 512 rows, padded to
    Mp = round_up(512, 128) + 24 * 128 = 3584)."""
    from repro_torch.kernels import gmm, ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    E, d, f, block_m = cfg.n_experts, cfg.d_model, cfg.d_ff_expert, 128
    T = 256
    logits = torch.randn((T, E), generator=gen, device=dev)
    idx = torch.topk(logits, cfg.top_k, dim=-1).indices.reshape(-1)
    idx = torch.sort(idx).values
    sizes = torch.bincount(idx, minlength=E).to(torch.int32)
    M = int(sizes.sum())
    dest, tg, mp = ops._pack_meta(sizes, M, E, block_m)
    used = int((sizes > 0).sum())

    def rows(k):  # inputs scaled so |out| < 4: one bf16 ulp < 2e-2 there
        x = 0.5 * torch.randn((M, k), generator=gen, device=dev)
        return ops._scatter_rows(x.to(torch.bfloat16), dest, mp)

    def weights(k, n):
        w = torch.randn((E, k, n), generator=gen, device=dev) / math.sqrt(k)
        return w.to(torch.bfloat16)

    out = []
    lhs, wg, wu = rows(d), weights(d, f), weights(d, f)
    got = gmm.gmm_glu_tiled_pair(lhs, wg, wu, tg, block_m=block_m)
    want = gmm.gmm_glu_plain(lhs, wg, wu, tg, block_m=block_m)
    torch.cuda.synchronize()
    err, tol, ok = compare(got, want)
    t_bound, by = bound(2 * (M * d + used * d * 2 * f + M * f),
                        2 * M * d * 2 * f)
    out.append({
        "name": "gmm_glu", "route": "cuda",
        "source": "src/repro_torch/csrc/gmm.cu",
        "replaces": "src/repro/kernels/gmm.py:222",
        "launches": launches["gmm_glu"], "max_abs_err": err, "tol": tol,
        "ok": ok,
        "ms": cuda_ms(lambda: gmm.gmm_glu_tiled_pair(lhs, wg, wu, tg,
                                                     block_m=block_m), 10),
        "plain_ms": cuda_ms(lambda: gmm.gmm_glu_plain(lhs, wg, wu, tg,
                                                      block_m=block_m), 5),
        "bound_ms": t_bound, "bound_by": by, "library_ms": None,
        "shapes": {"lhs": list(lhs.shape), "w": list(wg.shape),
                   "rows": M, "groups_used": used}})
    del lhs, wg, wu, got, want

    lhs, wo = rows(f), weights(f, d)
    got = gmm.gmm_tiled(lhs, wo, tg, block_m=block_m)
    want = gmm.gmm_tiled_plain(lhs, wo, tg, block_m=block_m)
    torch.cuda.synchronize()
    err, tol, ok = compare(got, want)
    t_bound, by = bound(2 * (M * f + used * f * d + M * d), 2 * M * f * d)
    # Yardstick only: PyTorch's grouped GEMM over the same packed groups
    # (group g owns rows [ends[g-1], ends[g]) of the padded layout).
    ends = torch.cumsum(torch.bincount(tg.long(), minlength=E) * block_m,
                        0).to(torch.int32)
    lib_ms, lib_note = None, "torch._grouped_mm not in this torch"
    if hasattr(torch, "_grouped_mm"):
        try:
            lib_ms = cuda_ms(lambda: torch._grouped_mm(lhs, wo, offs=ends),
                             10)
            lib_note = "torch._grouped_mm"
        except RuntimeError as e:  # optional yardstick: record why not
            lib_note = f"torch._grouped_mm refused: {str(e)[:160]}"
    out.append({
        "name": "gmm", "route": "cuda",
        "source": "src/repro_torch/csrc/gmm.cu",
        "replaces": "src/repro/kernels/gmm.py:69",
        "launches": launches["gmm"], "max_abs_err": err, "tol": tol,
        "ok": ok,
        "ms": cuda_ms(lambda: gmm.gmm_tiled(lhs, wo, tg, block_m=block_m),
                      10),
        "plain_ms": cuda_ms(lambda: gmm.gmm_tiled_plain(lhs, wo, tg,
                                                        block_m=block_m), 5),
        "bound_ms": t_bound, "bound_by": by, "library_ms": lib_ms,
        "library": lib_note,
        "shapes": {"lhs": list(lhs.shape), "w": list(wo.shape),
                   "rows": M, "groups_used": used}})
    return out


def check_paged_kernel(torch, cfg, launches):
    """Paged decode at the serve run's decode shapes: 4 slots, 26 table
    slots of 16 lines (max_len 416), a 104-page pool."""
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    B, KH, hd, ps, MP = 4, cfg.n_kv_heads, cfg.head_dim, 16, 26
    G, P = cfg.n_heads // KH, B * MP
    bf = torch.bfloat16
    q = torch.randn((B, KH, G, hd), generator=gen, device=dev).to(bf)
    kp = torch.randn((P, ps, KH, hd), generator=gen, device=dev).to(bf)
    vp = torch.randn((P, ps, KH, hd), generator=gen, device=dev).to(bf)
    table = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    table = table.reshape(B, MP).contiguous()
    q_pos = torch.tensor([415, 300, 131, 17], dtype=torch.int32, device=dev)
    for b, p in enumerate(q_pos.tolist()):  # pages past the frontier: -1
        table[b, p // ps + 1:] = -1
    kw = dict(scale=hd ** -0.5)
    got = pa.paged_decode_forward(q, kp, vp, table, q_pos, **kw)
    want = pa.paged_decode_plain(q, kp, vp, table, q_pos, **kw)
    torch.cuda.synchronize()
    err, tol, ok = compare(got, want, per_row=True)  # per slot
    lines = sum(p + 1 for p in q_pos.tolist())
    t_bound, by = bound(2 * (2 * q.numel() + 2 * lines * KH * hd),
                        4 * lines * KH * G * hd)
    return [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:109",
        "launches": launches["paged_decode"], "max_abs_err": err,
        "tol": tol, "ok": ok,
        "ms": cuda_ms(lambda: pa.paged_decode_forward(q, kp, vp, table,
                                                      q_pos, **kw), 50),
        "plain_ms": cuda_ms(lambda: pa.paged_decode_plain(q, kp, vp, table,
                                                          q_pos, **kw), 20),
        "bound_ms": t_bound, "bound_by": by, "library_ms": None,
        "shapes": {"q": list(q.shape), "pools": list(kp.shape),
                   "table": list(table.shape), "live_lines": lines}}]


def parity_f32(torch, serve_mod):
    """The paged engine (chunked prefill through the kernels, f32 policy)
    against the cache-free forward: first-token logits of the trace's first
    request whose prompt needs more than one prefill chunk."""
    from repro_torch.models import registry, stack
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.serve import ServeConfig, build_deployment
    args = serve_mod.build_parser().parse_args(SERVE_ARGS)
    cfg = registry.get_config("mixtral-w2")
    run = RunConfig(policy=Policy(compute_dtype=torch.float32))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = stack.init_model(gen, cfg, device="cuda")
    sc = ServeConfig.from_args(args)
    trace = serve_mod.build_trace(args.seed, args.requests, args.rate,
                                  args.prompt_len, args.gen, cfg.vocab_size,
                                  sc.sampling)
    req = next(r for r in trace if len(r.prompt) > args.prefill_chunk)
    engine = build_deployment(cfg, run, sc, params=params, device="cuda",
                              record_logits=True)
    engine.run([req])
    paged = torch.from_numpy(engine.logits[req.rid][0]).cuda()
    with torch.inference_mode():
        ref, _, _ = stack.apply_model(
            params, cfg, run,
            torch.tensor([req.prompt], dtype=torch.int64, device="cuda"))
    ref = ref[0, -1].float()
    diff = float((paged - ref).abs().max())
    scale = float(ref.abs().max())
    return {"rid": req.rid, "prompt": len(req.prompt),
            "prefill_chunks": engine.n_prefill_chunks,
            "max_abs_diff": diff, "max_abs_logit": scale,
            "limit": PARITY_REL * scale,
            "ok": diff <= PARITY_REL * scale
            and engine.n_prefill_chunks >= 2}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import registry

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32 here
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} | nvidia-smi: {smi}", flush=True)

    build_s = _build.build_all()
    print(f"build: {len(_build.sources())} CUDA sources compiled in "
          f"{build_s:.2f} s -> {_build.build_dir()}", flush=True)

    # -- untimed warm-up: one short request on an engine of its own ---------
    warm = serve_mod.serve_arch(
        "mixtral-w2", serve_mod.build_parser().parse_args(WARMUP_ARGS))
    if not warm["ok"]:
        raise RuntimeError("warm-up serve run failed its gate")
    torch.cuda.synchronize()
    print(f"warm-up: {warm['n_requests']} request, "
          f"{warm['n_generated_tokens']} tokens (untimed, not counted)",
          flush=True)

    # -- the main path: the port's serve driver at full width ---------------
    args = serve_mod.build_parser().parse_args(SERVE_ARGS)
    kernels.reset_launch_counts()
    summary = serve_mod.serve_arch("mixtral-w2", args)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if not summary["ok"]:
        raise RuntimeError("serve run failed its gate")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing} ({launches})")
    torch.cuda.empty_cache()

    # -- each kernel against its plain version at the main path's shapes ----
    cfg = registry.get_config("mixtral-w2")
    entries = check_gmm_kernels(torch, cfg, launches) \
        + check_paged_kernel(torch, cfg, launches)
    bad = [e["name"] for e in entries if not e["ok"]]
    torch.cuda.empty_cache()

    parity = parity_f32(torch, serve_mod)

    steps = summary["paged"]
    serve_line = {
        "arch": "mixtral-w2", "device": name, "nvidia_smi": smi,
        "requests": summary["n_requests"],
        "tokens": summary["n_generated_tokens"],
        "tokens_per_s": summary["tokens_per_s"],
        "ttft_p50_s": summary["ttft_s"]["p50"],
        "itl_p50_s": summary["itl_s"]["p50"],
        "prefill_chunks": steps["prefill_chunks"],
        "decode_steps": steps["decode_steps"],
        "launches": launches, "allocator_check": "clean",
        "page_peak": steps["page_peak"], "preempted": steps["n_preempted"]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": name, "nvidia_smi": smi, "build_s": build_s,
        "nvcc_reports": _build.build_logs(), "kernels": entries,
        "serve": serve_line, "parity": parity}, indent=1))

    contract = ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
    print("kernel tolerances: " + json.dumps(
        {e["name"]: e["tol"] for e in entries}), flush=True)
    print(json.dumps({"kernels": [{k: e[k] for k in contract}
                                  for e in entries]}), flush=True)
    print("serve: " + json.dumps(serve_line), flush=True)
    print("parity: " + json.dumps(parity), flush=True)
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions "
                           f"beyond their tolerance: {bad}")
    if not parity["ok"]:
        raise RuntimeError("paged engine logits disagree with the "
                           "cache-free forward under the f32 policy, or the "
                           "prompt did not span several chunks")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
