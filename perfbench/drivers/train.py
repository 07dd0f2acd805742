"""The training driver: one cell's set-up, measured window and check.

Set-up builds the program as the port's driver does
(``repro_torch.launch.train.build`` with the mix's run policy and the
configuration as a ``ModelConfig``), draws the weights from the seed in
the port's tree layout (:mod:`perfbench.model`), makes the batches on the
host (:mod:`perfbench.gen`), and drives the program through its first
``check_steps`` steps with ``TrainProgram.train_step``, on batches whose
rows all differ. Those steps build and load every kernel and warm every
shape the window uses; their readings are the program's side of the
check. The same program object and state then run the window: a closed
loop of ``train_step`` calls, each ending in ``torch.cuda.synchronize()``,
issued while the window is open. With ``--trace 1`` each step is split
into the benchmark's spans (``data``, ``gradient``, ``optimizer``, each
ending in a ``sync``) under ``torch.profiler``, and zebra's drop counter
is on.

After the window the peak memory is read, the program's state freed, and
the reference (:mod:`perfbench.reference`) runs the same first steps from
the same seed."""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch

from perfbench import check, flops, gen
from perfbench import reference as ref
from perfbench import trace as T
from perfbench.model import MoESpec, draw_leaf, draw_weights, nest


@dataclasses.dataclass
class Setup:
    m: MoESpec
    traffic: dict
    program: object
    params: dict
    opt_state: dict
    check_batches: list
    pool: list
    device: torch.device
    seed: int


def model_config(m: MoESpec):
    """The configuration as the port's ``ModelConfig`` (its Mixtral path:
    one attention + MoE layer pattern)."""
    from repro_torch.models.config import LayerSpec, ModelConfig
    return ModelConfig(
        name=m.name, family="moe", n_layers=m.n_layers, d_model=m.d_model,
        n_heads=m.n_heads, n_kv_heads=m.n_kv_heads, head_dim=m.head_dim,
        d_ff=m.d_ff, d_ff_expert=m.d_ff, vocab_size=m.vocab,
        pattern=(LayerSpec(mixer="attn", ffn="moe"),),
        n_experts=m.n_experts, top_k=m.top_k,
        capacity_factor=m.capacity_factor,
        router_aux_coef=m.router_aux_coef, router_z_coef=m.router_z_coef,
        rope_theta=m.rope_theta)


# What the port fixes in code, and so what a configuration must state.
PORT_NORM_EPS = 1e-6
PORT_LM_Z_COEF = 1e-4


def build_program(m: MoESpec, traffic: dict, device: str):
    """The port's train program of the mix, through its driver's
    ``build``; raises where the program would run otherwise than the
    configuration and the mix state."""
    from repro_torch.core.zebra_spmd import ZebraConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.models.modules import Policy, RunConfig

    if m.norm_eps != PORT_NORM_EPS or m.lm_z_coef != PORT_LM_Z_COEF:
        raise ValueError(f"the port runs rms eps {PORT_NORM_EPS} and "
                         f"z-loss {PORT_LM_Z_COEF}, not {m.norm_eps} / "
                         f"{m.lm_z_coef}")
    eng, opt = traffic["engine"], traffic["optimizer"]
    argv = ["--batch", str(traffic["batch"]), "--seq", str(traffic["seq"]),
            "--lr", repr(float(opt["peak_lr"])),
            "--steps", str(int(opt["total_steps"])), "--device", device]
    if not eng["zebra"]:
        argv.append("--no-zebra")
    args = train_mod.build_parser().parse_args(argv)
    run = RunConfig(policy=Policy(), attn_impl=eng["attn_impl"],
                    moe_impl="gather", remat=eng["remat"])
    zcfg = ZebraConfig(mode=eng["mode"],
                       num_microbatches=int(eng["microbatches"]),
                       capacity_factor=m.capacity_factor) \
        if eng["zebra"] else None
    _, program, _ = train_mod.build(m.name, args, run=run, zcfg=zcfg,
                                    cfg=model_config(m))
    oc = program.opt_cfg
    stated = {k: opt[k] for k in ("peak_lr", "warmup_steps", "total_steps",
                                  "end_lr_frac", "b1", "b2", "eps",
                                  "weight_decay", "grad_clip")}
    have = {k: getattr(oc, k) for k in stated}
    if have != stated:
        raise ValueError(f"the program's optimizer {have} is not the "
                         f"mix's {stated}")
    if eng["zebra"] and program.zcfg.num_microbatches != eng["microbatches"]:
        raise ValueError(f"zebra fitted {program.zcfg.num_microbatches} "
                         f"microbatches, not {eng['microbatches']}")
    shapes = {k: tuple(s) for k, (s, _) in m.layout().items()}
    if dict(program.layout.shapes) != shapes:
        raise ValueError("the program's parameter tree is not the "
                         "configuration's")
    return program


def setup(cell, seed: int, device: str = "cuda") -> Setup:
    m = MoESpec.from_config(cell.config)
    traffic = cell.traffic
    program = build_program(m, traffic, device)
    dev = torch.device(device)
    params = nest(draw_weights(m, seed, dev))
    opt_state = program.init_opt(params)
    n_check = int(traffic["check_steps"])
    batches = gen.batches(traffic, m.vocab, seed,
                          n_check + int(traffic["pool_batches"]))
    return Setup(m=m, traffic=traffic, program=program, params=params,
                 opt_state=opt_state, check_batches=batches[:n_check],
                 pool=batches[n_check:], device=dev, seed=seed)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def check_steps(s: Setup, step_fn) -> tuple:
    """Drive the program through the check steps with ``step_fn`` (its
    ``train_step``, or a fault in its place). Returns (readings, seconds
    spent reading them)."""
    b1 = s.traffic["optimizer"]["b1"]
    r = check.Readings([], {}, {})
    names, idx, read_s = list(s.m.layout()), {}, 0.0
    for i, batch in enumerate(s.check_batches):
        s.params, s.opt_state, met = step_fn(s.params, s.opt_state, batch)
        _sync(s.device)
        r.losses.append(float(met["loss"]))
        t = time.perf_counter()
        if i == 0:
            for k, v in s.opt_state["mu"].items():
                r.grads[k] = float(v.norm()) / (1 - b1)
                r.grad_samples[k] = check.sample(v, names.index(k),
                                                 idx) / (1 - b1)
        read_s += time.perf_counter() - t
    t = time.perf_counter()
    with torch.no_grad():
        for k, p in _flat(s.params).items():
            d = p - draw_leaf(s.m, s.seed, k, s.device)
            r.changes[k] = float(d.norm())
            r.change_samples[k] = check.sample(d, names.index(k), idx)
            del d
    read_s += time.perf_counter() - t
    return r, read_s


def _step_spans(s: Setup, i: int):
    """One window step under the benchmark's spans."""
    from repro_torch.train import optimizer as opt
    rf = torch.profiler.record_function
    with rf("data"):
        batch = s.pool[i % len(s.pool)]
    with rf("gradient"):
        grads, met = s.program.grad_fn(s.params, batch)
        with rf("sync"):
            _sync(s.device)
    with rf("optimizer"):
        s.params, s.opt_state, om = opt.adamw_update(
            s.program.opt_cfg, s.params, grads, s.opt_state)
        with rf("sync"):
            _sync(s.device)
    return dict(met, **om)


def window(s: Setup, seconds: float, step_fn, traced: bool) -> dict:
    """The measured window: steps issued while it is open, each ending in
    a device synchronize. Returns the steps, the time from the window's
    start to the end of the last step, their metrics and, traced, the
    profile."""
    mets, n, t_end = [], 0, None
    if s.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(s.device)
    prof = None
    if traced:
        from repro_torch.core import zebra_spmd
        zebra_spmd.reset_stats(True)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        if traced:
            met = _step_spans(s, n)
        else:
            s.params, s.opt_state, met = step_fn(
                s.params, s.opt_state, s.pool[n % len(s.pool)])
            _sync(s.device)
        t_end = time.perf_counter()
        mets.append(met)
        n += 1
    out = {"steps": n, "seconds": t_end - t0, "mets": mets}
    if traced:
        prof.__exit__(None, None, None)
        from repro_torch.core import zebra_spmd
        out["zebra"] = zebra_spmd.read_stats() if s.program.zcfg else None
        zebra_spmd.reset_stats(False)
        out["prof"] = prof
    out["peak_bytes"] = torch.cuda.max_memory_allocated(s.device) \
        if s.device.type == "cuda" else 0
    return out


def free(s: Setup) -> None:
    """Drop the program and its state, so the reference has the card."""
    s.params = s.opt_state = s.program = None
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_readings(s: Setup, prec=ref.EXACT) -> check.Readings:
    return ref.train_steps(s.m, s.seed, s.check_batches,
                           s.traffic["engine"], s.traffic["optimizer"],
                           s.device, prec)


def run(cell, seed: int, seconds: float, traced: bool, t_start: float, *,
        device: str = "cuda", fault=None) -> dict:
    """One run of a training cell: the result's fields (``correct``,
    ``attempted``, ``failed``, end-to-end values, the trace, the device
    reading and the checks). ``fault(program)`` -> step function puts a
    broken step in the program's place (the harness's own tests)."""
    s = setup(cell, seed, device)
    step_fn = fault(s.program) if fault else s.program.train_step
    side, read_s = check_steps(s, step_fn)
    setup_s = time.perf_counter() - t_start - read_s
    w = window(s, seconds, step_fn, traced)
    m, B, S = s.m, s.traffic["batch"], s.traffic["seq"]
    failed = sum(1 for met in w["mets"]
                 if not (math.isfinite(float(met["loss"]))
                         and math.isfinite(float(met["grad_norm"]))))
    rate = w["steps"] * B * S / w["seconds"]
    e2e = {"setup_s": setup_s, "train_tokens_per_s": rate,
           "mfu": 100.0 * w["steps"] * flops.model_flops(m, B, S)
           / (w["seconds"] * flops.H100_PEAK_BF16)}
    tr = None
    if traced:
        tr = T.from_profile(w.pop("prof"), w["seconds"], w["steps"],
                            {"model": m, "batch": B, "seq": S,
                             "zebra": w.get("zebra"),
                             "peak_bytes": w["peak_bytes"]})
    free(s)
    correct, checks = check.verdict(side, reference_readings(s), cell.limits)
    return {"correct": correct, "attempted": w["steps"], "failed": failed,
            "e2e": e2e, "trace": tr, "peak_bytes": w["peak_bytes"],
            "checks": checks}
