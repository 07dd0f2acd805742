"""Shared helpers of the ``test_torch_*`` parity tests (not a test module).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs as its own tests run it on the CPU (Pallas kernels in
interpret mode, ``Policy(compute_dtype=float32)``), the port runs the
plain versions of its kernels (CPU tensors).
"""

import contextlib

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_single_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's default thread pool oversubscribes them by ~50x."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def to_np(x):
    """jax array / torch tensor -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_values_np(tree):
    """A JAX value tree (nested dicts) -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: jax_values_np(v) for k, v in tree.items()}
    return np.asarray(tree)


# The cross-attention archs. The reference initialises each cross-attention
# gate ``xgate`` to 0 and its drivers feed zero fronts, so at init a
# cross-attention adds exactly 0 and nothing reaches its weights, the
# encoder or ``vision_proj``: their parity tests set every gate to
# XATTN_GATE in both trees and draw the fronts from a numpy seed.
XATTN_ARCHS = ("whisper-tiny", "llama-3.2-vision-90b")
XATTN_GATE = 0.8


def with_gate(tree, gate):
    """The tree with every ``xgate`` leaf set to ``gate`` (new leaves; the
    others shared): a JAX value tree or the port's."""
    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "xgate":
                out[k] = v * 0 + gate  # a tensor or array of v's kind
            else:
                out[k] = v
        return out
    return walk(tree)


def fronts_np(cfg, batch, seed):
    """Random front embeddings of an arch, numpy f32 from ``seed``."""
    rng = np.random.RandomState(seed)
    out = {}
    if cfg.is_encdec:
        out["encoder_embeds"] = rng.randn(
            batch, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    if cfg.vision_seq > 0:
        out["vision_embeds"] = rng.randn(
            batch, cfg.vision_seq, cfg.vision_dim or cfg.d_model).astype(
                np.float32)
    return out


def split3(x):
    """The tensor-core kernels' split of f32 x (csrc/sm90.cuh split3):
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded
    to nearest even; hi + mid + lo == x for 2^-110 <= |x| <
    (2 - 2^-8) 2^127 (tests/test_torch_gmm_dw.py holds it)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def ep_rank_worker(rank: int, world: int, init_file: str, in_path: str,
                   out_dir: str):
    """One EP rank of the two-rank zebra test (``torch.multiprocessing``
    target; imports no jax). Reads the cases of ``in_path`` (an npz of
    global inputs and a JSON list of cases), joins a gloo group through
    ``init_file``, runs ``zebra_spmd.make_ep_moe`` on its share and writes
    its output, aux losses and gradients to ``out_dir/<case>_<rank>.npz``.

    A rank's loss is its share of the global one: Σ y·ct over its rows
    (1/world of it in replicated mode, whose y is replicated) plus each
    aux loss times its cotangent over world (aux is replicated)."""
    import json

    import torch.distributed as dist

    from repro_torch.core import zebra_spmd as zs
    from repro_torch.models import registry
    from repro_torch.models.modules import Policy, RunConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    cfg = registry.smoke_config(registry.get_config("mixtral-w1"))
    run = RunConfig(policy=Policy(compute_dtype=torch.float32))
    data = np.load(in_path)
    aux_ct = json.loads(str(data["aux_ct"]))
    for case in json.loads(str(data["cases"])):
        zcfg = zs.ZebraConfig(**case["zcfg"])
        moe_fn = zs.make_ep_moe(cfg, run, zcfg, group=dist.group.WORLD)
        x, ct = data["x"], data["ct"]
        share = 1.0 / world
        if zcfg.mode == "alltoall":  # the batch is sharded over the ranks
            n = x.shape[0] // world
            x, ct = x[rank * n:(rank + 1) * n], ct[rank * n:(rank + 1) * n]
            share = 1.0
        p = {k: torch.from_numpy(data[k].copy()).requires_grad_(True)
             for k in ("router", "wi_gate", "wi_up", "wo")}
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        y, aux = moe_fn(p, xt)
        loss = (y * torch.from_numpy(ct)).sum() * share + sum(
            aux[k] * c / world for k, c in aux_ct.items())
        loss.backward()
        np.savez(f"{out_dir}/{case['name']}_{rank}.npz", y=to_np(y),
                 dx=to_np(xt.grad),
                 **{f"aux_{k}": to_np(v) for k, v in aux.items()},
                 **{f"d_{k}": to_np(t.grad) for k, t in p.items()})
    dist.destroy_process_group()


def compress_rank_worker(rank: int, world: int, init_file: str, in_path: str,
                         out_dir: str):
    """One rank of the two-rank ``compressed_psum`` test
    (``torch.multiprocessing`` target; imports no jax): its share of the
    rows of ``grads`` and ``err`` in ``in_path`` through
    ``train.compression.compressed_psum`` over a gloo group joined through
    ``init_file``; writes the mean and its new error state to
    ``out_dir/psum_<rank>.npz``."""
    import torch.distributed as dist

    from repro_torch.train import compression as comp

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    data = np.load(in_path)
    n = data["grads"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    grads = {"w": torch.from_numpy(data["grads"][rows].copy())}
    err = {"w": torch.from_numpy(data["err"][rows].copy())}
    mean, new_err = comp.compressed_psum(grads, err, group=dist.group.WORLD)
    np.savez(f"{out_dir}/psum_{rank}.npz", mean=to_np(mean["w"]),
             err=to_np(new_err["w"]))
    dist.destroy_process_group()


def ep_decode_rank_worker(rank: int, world: int, init_file: str,
                          in_path: str, out_dir: str):
    """One EP rank of the two-rank EP decode test (``torch.multiprocessing``
    target; imports no jax). Reads the JAX package's smoke
    qwen3-moe-30b-a3b params (flat, ``p/<path>``), the hop cases and the
    trace of ``in_path``, joins a gloo group through ``init_file``, takes
    the 1 x world serving mesh (its "model" axis: the EP ranks) and
    writes to ``out_dir/ep_<rank>.npz``:

    * each hop case's y, ep_counts and aux losses from
      ``ep_decode.make_ep_moe_decode`` on layer 0 of the params placed for
      this rank (it holds E / world experts);
    * the greedy tokens (JSON) of ``EPContinuousBatchingEngine`` at
      ep_size = world over the group: dense, paged, and paged with a
      re-balance to the reversed shard order at tick 5, with the EMA's
      update count and merged distribution."""
    import json

    import torch.distributed as dist

    from repro_torch.core.zebra_mpmd import _unflatten
    from repro_torch.core.zebra_spmd import EPGroup
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.pytree import params_from_jax
    from repro_torch.serve import (BlockAllocator, PagedCfg, Request,
                                   Scheduler, ServeConfig,
                                   make_continuous_program)
    from repro_torch.serve import ep_decode as epd
    from repro_torch.serve.sampling import GREEDY

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    mesh = make_mesh((1, world), ("data", "model"), "cpu")
    group = EPGroup(mesh.group("model"))
    cfg = registry.smoke_config(registry.get_config("qwen3-moe-30b-a3b"))
    run = RunConfig(policy=Policy(compute_dtype=torch.float32))
    data = np.load(in_path)
    params = params_from_jax(_unflatten(
        {k[2:]: data[k] for k in data.files if k.startswith("p/")}))
    placement = json.loads(str(data["placement"]))
    out = {}
    placed = epd.place_params(params, cfg, placement, group)
    ffn = {k: v[0] for k, v in placed["blocks"]["pos0"]["ffn"].items()}
    out["experts_held"] = np.asarray(ffn["wi_gate"].shape[0])
    for case in json.loads(str(data["hop_cases"])):
        moe_fn = epd.make_ep_moe_decode(
            cfg, run, epd.EPDecodeConfig(ep_size=world,
                                         n_chunks=case["Q"]), group)
        x = torch.from_numpy(data[f"x_{case['name']}"].copy())
        m = torch.from_numpy(data[f"m_{case['name']}"].copy())
        with torch.inference_mode():
            y, aux = moe_fn(ffn, x, m)
        out[f"y_{case['name']}"] = to_np(y)
        for k, v in aux.items():
            out[f"{k}_{case['name']}"] = to_np(v)
    tokens = {}
    trace = json.loads(str(data["trace"]))
    for name, paged, rebalance_at in (("dense", False, None),
                                      ("paged", True, None),
                                      ("rebalance", True, 5)):
        sc = ServeConfig(slots=3, max_len=24, prefill_chunk=4,
                         paged=PagedCfg(enabled=paged, page_size=4))
        prog = make_continuous_program(
            cfg, run, sc, device="cpu", mesh=mesh,
            ep=epd.EPDecodeConfig(ep_size=world, n_chunks=2))
        alloc = BlockAllocator(prog.n_pages, prog.page_size,
                               prog.max_pages) if paged else None
        eng = epd.EPContinuousBatchingEngine(
            prog, params, Scheduler(3, 24, prefill_chunk=4,
                                    allocator=alloc))
        pending = [Request(rid=r["rid"], prompt=r["prompt"],
                           max_new_tokens=r["gen"], sampling=GREEDY,
                           arrival=r["arrival"]) for r in trace]
        n = 0
        while pending or eng.sched.has_work() or eng._active.any():
            while pending and pending[0].arrival <= eng.tick_count:
                eng.submit(pending.pop(0))
            eng.tick()
            n += 1
            if n == rebalance_at:
                assert eng.rebalance(tuple(reversed(eng.placement)))
        tokens[name] = {"results": {str(k): v for k, v in
                                    eng.results.items()},
                        "n_rebalances": eng.n_rebalances,
                        "ema_updates": eng.ema.n_updates,
                        "ema_merged": eng.ema.merged().tolist(),
                        "experts_held": int(eng.params["blocks"]["pos0"][
                            "ffn"]["wi_gate"].shape[1])}
    np.savez(f"{out_dir}/ep_{rank}.npz", tokens=json.dumps(tokens), **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The mesh program's ranks (tests/test_torch_mesh_train.py, _mesh_ckpt.py)
# ---------------------------------------------------------------------------

MESH_B, MESH_S, MESH_STEPS = 8, 32, 5


def mesh_opt_cfg(mod):
    return mod.OptimizerConfig(peak_lr=3e-3, warmup_steps=2,
                               total_steps=MESH_STEPS)


def skewed_token_file(path):
    """A token .bin drawn from a geometric law (a few tokens dominate), so
    routing is skewed and capacity 1.25 drops token copies."""
    rng = np.random.default_rng(5)
    n = MESH_STEPS * MESH_B * MESH_S + 1
    (rng.geometric(0.08, size=n) % 256).astype(np.uint16).tofile(path)
    return str(path)


def mesh_case_config(registry, case):
    """The smoke config of a mesh test case's arch, with the case's
    ``cfg`` overrides (``registry``: either package's)."""
    import dataclasses
    return dataclasses.replace(
        registry.smoke_config(registry.get_config(case["arch"])),
        **case.get("cfg", {}))


def mesh_model_key(case) -> str:
    """The name of a mesh test case's model (its arch, and its ``cfg``
    overrides), which keys its JAX init in a worker's inputs."""
    return case["arch"] + "".join(f"-{k}{v}" for k, v in
                                  sorted(case.get("cfg", {}).items()))


def mesh_program(case, mesh):
    """The port's mesh program of a test case (f32 policy, chunked
    attention in query chunks of 16; the case's ``remat``, else "full",
    and ``seq``, else MESH_S)."""
    from repro_torch.core.zebra_spmd import ZebraConfig
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_program

    cfg = mesh_case_config(registry, case)
    run = RunConfig(policy=Policy(compute_dtype=torch.float32),
                    attn_impl="chunked", moe_impl="gather",
                    remat=case.get("remat", "full"), chunk_q=16)
    z = case.get("zcfg")
    return cfg, make_train_program(
        cfg, run, ShapeConfig("t", "train", case.get("seq", MESH_S), MESH_B),
        opt_cfg=mesh_opt_cfg(opt), device="cpu", mesh=mesh,
        zcfg=None if z is None else ZebraConfig(capacity_factor=1.25, **z),
        accum_steps=case.get("accum", 1))


def mesh_train_worker(rank: int, in_path: str, out_dir: str):
    """One rank of a mesh-program test (``launch.mesh.launch_ranks``
    target; imports no jax). ``in_path``: an npz of the cases (JSON), the
    token file's path and the JAX init of each model
    (``<mesh_model_key>|<path>``).
    For each case: the mesh, this rank's blocks of the init, five steps on
    the global batches, then ``out_dir/<case>_<rank>.npz`` with the
    metrics, the final blocks (``p|<path>``), the param and moment block
    shapes, the params' specs, the zebra engine's dropped share and the
    ``obs.census.mesh_census`` of the first step (``census``). A
    case with ``save`` also checkpoints after that step (``ckpt`` dir,
    blocking) and a case with ``restore`` starts from that step of its
    ``ckpt`` dir (the restored blocks saved as ``r|params/<path>``,
    ``r|opt/...``)."""
    import json

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import zebra_spmd
    from repro_torch.data import DataConfig, DataLoader
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.census import mesh_census
    from repro_torch.pytree import flatten

    torch.set_num_threads(1)
    data = np.load(in_path)
    for case in json.loads(str(data["cases"])):
        mesh = make_mesh(case["mesh"], ("data", "model"), "cpu")
        cfg, prog = mesh_program(case, mesh)
        lay = prog.layout
        params = {}
        for path in lay.shapes:
            full = torch.from_numpy(
                data[f"{mesh_model_key(case)}|{path}"].copy())
            node = params
            *parents, leaf = path.split("/")
            for q in parents:
                node = node.setdefault(q, {})
            node[leaf] = lay.local(path, full).clone()
        state = prog.init_opt(params)
        loader = DataLoader(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=case.get("seq", MESH_S),
                                       global_batch=MESH_B,
                                       path=str(data["tokens"])))
        start, restored = 0, {}
        ckpt = CheckpointManager(case["ckpt"], mesh=mesh) \
            if "ckpt" in case else None
        if case.get("restore"):
            start, params, state, extra = ckpt.restore(
                params, state, step=case["restore"],
                shardings=lay.param_specs, opt_shardings=lay.opt_specs)
            loader.load_state_dict(extra["loader"])
            restored = {f"r|{k}": to_np(v).copy() for k, v in
                        flatten({"params": params, "opt": state}).items()}
        zebra_spmd.reset_stats(True)
        hist, census = [], {}
        for step in range(start, MESH_STEPS):
            with mesh_census() if step == start \
                    else contextlib.nullcontext() as rec:
                params, state, m = prog.train_step(params, state,
                                                   next(loader))
            census = rec or census
            hist.append({k: float(v) for k, v in m.items()})
            if case.get("save") == step + 1:
                ckpt.save(step + 1, params, state,
                          extra={"loader": loader.state_dict()},
                          shardings=lay.param_specs,
                          opt_shardings=lay.opt_specs)
        if ckpt is not None:
            ckpt.wait()
        stats = zebra_spmd.read_stats()
        zebra_spmd.reset_stats(False)
        flat = flatten(params)
        np.savez(f"{out_dir}/{case['name']}_{rank}.npz",
                 hist=json.dumps(hist),
                 dropped=stats.get("dropped_share", 0.0),
                 shapes=json.dumps({k: list(v.shape)
                                    for k, v in flat.items()}),
                 mu_shapes=json.dumps({k: list(v.shape)
                                       for k, v in state["mu"].items()}),
                 specs=json.dumps(lay.param_specs),
                 census=json.dumps(census), **restored,
                 **{f"p|{k}": to_np(v) for k, v in flat.items()})


# ---------------------------------------------------------------------------
# The serving mesh's ranks (tests/test_torch_serve_mesh*.py)
# ---------------------------------------------------------------------------

SERVE_STEP_S = 1e-3  # the step time a mesh fleet's straggler detector records


def serve_config(mod, d: dict):
    """A ``ServeConfig`` of either package (``mod``: its ``serve.config``
    module) from a case's JSON dict of sections."""
    sub = {"paged": mod.PagedCfg, "prefix": mod.PrefixCacheCfg,
           "disagg": mod.DisaggCfg, "ep": mod.EPCfg, "fleet": mod.FleetCfg}
    kw = {}
    for k, v in d.items():
        if k in sub:
            v = dict(v)
            for t in ("prefill_groups", "decode_groups", "kills"):
                if t in v:
                    v[t] = tuple(tuple(x) if isinstance(x, list) else x
                                 for x in v[t])
            kw[k] = sub[k](**v)
        else:
            kw[k] = v
    return mod.ServeConfig(**kw)


def serve_requests(Request, sampling, trace):
    """A trace of JSON request dicts as ``Request`` objects of a package."""
    return [Request(rid=r["rid"], prompt=list(r["prompt"]),
                    max_new_tokens=r["gen"], sampling=sampling,
                    arrival=r["arrival"], tenant=r.get("tenant", 0))
            for r in trace]


def serve_engine_states(eng) -> dict:
    """{part: state tree} of a deployment: the unified engine's state, the
    disaggregated workers', or every fleet group's."""
    if hasattr(eng, "groups"):
        return {f"g{g.gid}": g.worker.state for g in eng.groups}
    if hasattr(eng, "prefill") and hasattr(eng, "decode"):
        return {"prefill": eng.prefill.state, "decode": eng.decode.state}
    return {"state": eng.state}


def serve_engine_workers(eng) -> dict:
    """{part: the engine or worker holding that part's state}, the parts
    of :func:`serve_engine_states`."""
    if hasattr(eng, "groups"):
        return {f"g{g.gid}": g.worker for g in eng.groups}
    if hasattr(eng, "prefill") and hasattr(eng, "decode"):
        return {"prefill": eng.prefill, "decode": eng.decode}
    return {"state": eng}


REC_SUFFIXES = ("/conv", "/lru", "/ssm")


def snapshot_live_states(eng, leaves) -> dict:
    """Wrap ``eng.tick`` (the engine of either package) so that after the
    first tick with the most live decode slots the returned dict holds
    each part's live-slot mask (``live``; all rows of a part without
    slots) and its recurrent state leaves (``state``: ``leaves(part,
    tree)`` -> {part|leaf: value}). A dead slot's recurrent state is not
    read again (the next admission overwrites its row) and the packages
    fill it differently: a dead slot's queries see no key, which the port
    counts as a zero output; so states are held on live rows."""
    box = {"n": -1}
    tick = eng.tick

    def wrapped():
        tick()
        live = {part: np.asarray(w._active).copy()
                for part, w in serve_engine_workers(eng).items()
                if hasattr(w, "_active")}
        n = sum(int(a.sum()) for a in live.values())
        if n > box["n"]:
            state = {}
            for part, st in serve_engine_states(eng).items():
                state.update(leaves(part, st))
            box.update(n=n, live=live, state=state)
    eng.tick = wrapped
    return box


def serve_engine_params(eng):
    if hasattr(eng, "groups"):
        return eng.groups[0].worker.params
    if hasattr(eng, "decode"):
        return eng.decode.params
    return eng.params


def serve_engine_logits(eng) -> dict:
    if hasattr(eng, "groups"):
        return {}
    src = eng.decode if hasattr(eng, "decode") else eng
    return {rid: rows[0] for rid, rows in src.logits.items()}


def serve_case_config(registry, case: dict):
    """The smoke config of a serving-mesh case in either package
    (``registry``: its ``models.registry``). A case with ``window`` W
    serves its arch with the pattern (local_attn, attn), twice over as
    the smoke configs repeat theirs, and a W-line sliding window, so
    every other layer's dense cache is a ring."""
    import dataclasses
    cfg = registry.smoke_config(registry.get_config(case["arch"]))
    if case.get("window"):
        spec = type(cfg.pattern[0])
        cfg = dataclasses.replace(
            cfg, window=case["window"], n_layers=4,
            pattern=(spec(mixer="local_attn"), spec()))
    return cfg


def serve_case_model(case: dict) -> str:
    """The key of a case's model config (its arch, and its window)."""
    w = case.get("window")
    return f"{case['arch']}@w{w}" if w else case["arch"]


def serve_mesh_worker(rank: int, in_path: str, out_dir: str):
    """One rank of a serving-mesh test (``launch.mesh.launch_ranks``
    target; imports no jax). ``in_path``: an npz of the cases (JSON: name,
    arch, mesh, serve config sections, trace) and the JAX init of each
    arch (``<arch>|<path>``). For each case: the deployment on this rank
    of the mesh (f32, greedy), the trace served, then
    ``out_dir/<case>_<rank>.npz`` with the results (JSON), the first-token
    logits by rid, the param block shapes (JSON), every state block
    (``s|<part>|<leaf>``) and the run's ``obs.census.serve_census``, each
    list's distinct values (JSON ``census``)."""
    import json

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry, stack
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.pytree import flatten, params_from_jax
    from repro_torch.serve import GREEDY, Request, build_deployment
    from repro_torch.serve import config as serve_config_mod
    from repro_torch.core.zebra_mpmd import _unflatten
    from repro_torch.obs.census import serve_census

    torch.set_num_threads(1)
    data = np.load(in_path)
    run = RunConfig(policy=Policy(compute_dtype=torch.float32))
    for case in json.loads(str(data["cases"])):
        mesh = make_mesh(case["mesh"], ("data", "model"), "cpu")
        cfg = serve_case_config(registry, case)
        pre = f"{serve_case_model(case)}|"
        params = params_from_jax(_unflatten(
            {k[len(pre):]: data[k] for k in data.files
             if k.startswith(pre)}))
        sc = serve_config(serve_config_mod, case["sc"])
        eng = build_deployment(cfg, run, sc, params=params, device="cpu",
                               record_logits=not sc.fleet.enabled,
                               mesh=mesh)
        reqs = serve_requests(Request, GREEDY, case["trace"])
        snap = snapshot_live_states(eng, lambda part, st: {
            f"{part}|{k}": to_np(v).copy()
            for k, v in stack.state_leaves(st).items()
            if k.endswith(REC_SUFFIXES)})
        with serve_census() as census:
            if sc.fleet.enabled:
                record = eng.detector.record
                eng.detector.record = lambda g, _t: record(g, SERVE_STEP_S)
                results = eng.run(reqs, kills=list(sc.fleet.kills))
            else:
                results = eng.run(reqs)
        out = {"results": json.dumps({str(k): v
                                      for k, v in results.items()}),
               "census": json.dumps({k: sorted(set(map(json.dumps, v)))
                                     for k, v in census.items()}),
               **{f"a|{p}": m for p, m in snap.get("live", {}).items()},
               **{f"r|{k}": v for k, v in snap.get("state", {}).items()},
               "params": json.dumps({k: list(v.shape) for k, v in
                                     flatten(serve_engine_params(eng))
                                     .items()})}
        for rid, row in serve_engine_logits(eng).items():
            out[f"l|{rid}"] = np.asarray(row)
        for part, st in serve_engine_states(eng).items():
            for k, v in stack.state_leaves(st).items():
                out[f"s|{part}|{k}"] = to_np(v)
        np.savez(f"{out_dir}/{case['name']}_{rank}.npz", **out)


def ssd_gather_worker(rank: int, out_dir: str):
    """One rank of a 1x2 serving mesh (``launch_ranks`` target) serving
    smoke mamba2-2.7b dense with two slots, f32: two requests admitted,
    then the input shape, dim and group size of every all-gather of one
    decode step (``collectives._gather``, which every gather runs through)
    to ``out_dir/gathers_<rank>.json``."""
    import json

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.serve import GREEDY, Request, build_deployment
    from repro_torch.serve.config import ServeConfig
    from repro_torch.sharding import collectives as C

    torch.set_num_threads(1)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    cfg = registry.smoke_config(registry.get_config("mamba2-2.7b"))
    run = RunConfig(policy=Policy(compute_dtype=torch.float32))
    eng = build_deployment(cfg, run, ServeConfig(slots=2, max_len=32,
                                                 prefill_chunk=8),
                           device="cpu", mesh=mesh)
    for rid in range(2):
        eng.submit(Request(rid=rid, prompt=list(range(3 + rid, 11 + rid)),
                           max_new_tokens=6, sampling=GREEDY))
    for _ in range(8):
        if int(eng._active.sum()) == 2:
            break
        eng.tick()
    assert int(eng._active.sum()) == 2
    seen, gather = [], C._gather

    def record(t, dim, group):
        seen.append([list(t.shape), dim, C.group_size(group),
                     t.element_size()])
        return gather(t, dim, group)
    C._gather = record
    try:
        steps = eng.n_decode_steps
        eng.tick()
        assert eng.n_decode_steps == steps + 1
    finally:
        C._gather = gather
    with open(f"{out_dir}/gathers_{rank}.json", "w") as f:
        json.dump(seen, f)


def serve_trace(arch: str, n: int, *, seed=3, rate=0.8, prompt_len=20,
                gen=8, tenants=0):
    """A serve trace as JSON request dicts, drawn by the port driver's
    numpy generators (the JAX driver's, draw for draw)."""
    import types

    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import registry
    from repro_torch.serve import GREEDY
    vocab = registry.smoke_config(registry.get_config(arch)).vocab_size
    if tenants:
        args = types.SimpleNamespace(
            seed=seed, requests=n, tenants=tenants, rate=rate,
            prompt_len=prompt_len, gen=gen, shared_prefix_len=None)
        reqs = serve_mod.build_tenant_trace(args, vocab, GREEDY)
    else:
        reqs = serve_mod.build_trace(seed, n, rate, prompt_len, gen, vocab,
                                     GREEDY)
    return [{"rid": r.rid, "prompt": list(r.prompt),
             "gen": r.max_new_tokens, "arrival": r.arrival,
             "tenant": r.tenant} for r in reqs]


def jax_serve_params(case: dict) -> dict:
    """The JAX package's seed-0 init of a case's smoke config, numpy by
    path."""
    import jax

    from repro.models import registry as jreg
    from repro.models import stack as jstack
    from repro.pytree import split_params, tree_map_with_path_names
    jcfg = serve_case_config(jreg, case)
    tree = split_params(jstack.init_model(jax.random.PRNGKey(0), jcfg))[0]
    out = {}
    tree_map_with_path_names(
        lambda n, v: out.__setitem__(n, np.asarray(v)), tree)
    return out


def jax_serve_run(case: dict, mesh, flat_params: dict) -> dict:
    """The JAX deployment of ``case`` on ``mesh`` (f32, greedy, the same
    trace): results, first-token logits by rid, {path: param shard shape}
    and {part|leaf: {mesh coords: shard}} of every state leaf."""
    import jax.numpy as jnp

    from repro_torch.core.zebra_mpmd import _unflatten as junflatten
    from repro.models import registry as jreg
    from repro.models.modules import Policy as JPolicy
    from repro.models.modules import RunConfig as JRun
    from repro.pytree import tree_map_with_path_names
    from repro.serve import config as jconfig
    from repro.serve.sampling import GREEDY as JGREEDY
    from repro.serve.scheduler import Request as JRequest

    jcfg = serve_case_config(jreg, case)
    run = JRun(policy=JPolicy(compute_dtype=jnp.float32), attn_impl="ref",
               moe_impl="gather")
    sc = serve_config(jconfig, case["sc"])
    params = junflatten({k: jnp.asarray(v) for k, v in flat_params.items()})
    eng = jconfig.build_deployment(jcfg, mesh, run, sc, params=params,
                                   record_logits=not sc.fleet.enabled)
    reqs = serve_requests(JRequest, JGREEDY, case["trace"])
    coord = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
             for d in mesh.devices.flat}

    def rec_shards(part, st):
        out = {}
        tree_map_with_path_names(lambda n, v: out.__setitem__(
            f"{part}|{n}", {coord[s.device.id]: np.array(s.data)
                            for s in v.addressable_shards})
            if n.endswith(REC_SUFFIXES) else None, st)
        return out
    snap = snapshot_live_states(eng, rec_shards)
    if sc.fleet.enabled:
        record = eng.detector.record
        eng.detector.record = lambda g, _t: record(g, SERVE_STEP_S)
        results = eng.run(reqs, kills=list(sc.fleet.kills))
    else:
        results = eng.run(reqs)
    if hasattr(eng, "ema"):       # the EP engine holds its placed params
        shapes = {}
        tree_map_with_path_names(lambda n, v: shapes.__setitem__(
            n, tuple(v.sharding.shard_shape(v.shape))),
            serve_engine_params(eng))
    else:
        prog = (eng.groups[0].worker.p if hasattr(eng, "groups") else
                eng.decode.p if hasattr(eng, "decode") else eng.p)
        shapes = {}
        tree_map_with_path_names(
            lambda n, s, v: shapes.__setitem__(
                n, tuple(s.shard_shape(np.shape(v)))),
            prog.param_shardings, params)
    state = {}
    for part, st in serve_engine_states(eng).items():
        tree_map_with_path_names(lambda n, v: state.__setitem__(
            f"{part}|{n}", {coord[s.device.id]: np.asarray(s.data)
                            for s in v.addressable_shards}), st)
    return {"results": {int(k): list(v) for k, v in results.items()},
            "logits": {rid: np.asarray(r) for rid, r in
                       serve_engine_logits(eng).items()},
            "shapes": shapes, "state": state, "snap": snap}


def run_beside_jax(tmp, world: int, worker, cases: list, inputs: dict,
                   jax_run) -> tuple:
    """The port's ranks (``launch_ranks`` of ``worker(rank, in_path,
    out_dir)``, spawned from a thread, reading ``tmp/in.npz``: the JSON
    ``cases`` and ``inputs``) beside ``jax_run(case)`` for each case in
    this thread: ({case: JAX run}, {case: [rank outputs]})."""
    import json
    import threading

    from repro_torch.launch.mesh import launch_ranks
    np.savez(tmp / "in.npz", cases=json.dumps(cases), **inputs)
    box = {}

    def ranks():
        try:
            launch_ranks(worker, world, "cpu", str(tmp / "in.npz"),
                         str(tmp))
        except BaseException as e:  # re-raised in the test's thread
            box["error"] = e

    t = threading.Thread(target=ranks)
    t.start()
    try:
        ref = {c["name"]: jax_run(c) for c in cases}
    finally:
        t.join()
    if "error" in box:
        raise box["error"]
    return ref, {c["name"]: [dict(np.load(tmp / f"{c['name']}_{r}.npz"))
                             for r in range(world)] for c in cases}


def run_serve_mesh(tmp, mesh, world: int, cases: list) -> tuple:
    """The port's ranks (``serve_mesh_worker``) beside the JAX
    deployments on ``mesh`` (:func:`run_beside_jax`)."""
    inits = {}
    for c in cases:
        if serve_case_model(c) not in inits:
            inits[serve_case_model(c)] = jax_serve_params(c)
    return run_beside_jax(
        tmp, world, serve_mesh_worker, cases,
        {f"{a}|{k}": v for a, p in inits.items() for k, v in p.items()},
        lambda c: jax_serve_run(c, mesh, inits[serve_case_model(c)]))


LOGIT_TIER = 2e-5   # first-token logits, relative to max |logit|
KV_TIER = 1e-5      # KV blocks on live lines, relative to the leaf's max
REC_TIER = 1e-5     # recurrent state blocks, relative to the leaf's max


def model_cut_leaves(case: dict) -> list:
    """The recurrent state leaves (``conv``, ``lru``, ``ssm``) of a case's
    decode state that its mesh cuts over "model", by the port's specs
    (the JAX package's, ``tests/test_torch_serve_mesh_modes.py``)."""
    from repro_torch.models import registry
    from repro_torch.serve import mesh as serve_mesh
    from repro_torch.sharding.rules import (MeshShape, entry_axes,
                                            rules_for)
    cfg = serve_case_config(registry, case)
    mesh = MeshShape(tuple(case["mesh"]), ("data", "model"))
    sc = case["sc"]
    specs = serve_mesh.decode_state_specs(
        cfg, mesh, rules_for(cfg, mesh, "serve"), sc["slots"],
        sc["max_len"])
    return sorted(k for k, s in specs.items()
                  if k.endswith(("/conv", "/lru", "/ssm"))
                  and any("model" in entry_axes(e) for e in s)
                  and mesh.shape["model"] > 1)


def check_serve_mesh(case: dict, ref: dict, per: list) -> None:
    """Hold each rank's outputs of ``case`` against the JAX run: tokens
    equal; first-token logits within LOGIT_TIER * max|logit|; param block
    shapes and state block shapes equal the JAX shards at the rank's mesh
    coordinate; KV blocks within KV_TIER * max on the lines whose
    position is >= 0 (positions equal); recurrent state blocks (``conv``,
    ``lru``, ``ssm``) within REC_TIER * max of the shard."""
    import json
    d, m = case["mesh"]
    n_live = 0
    for r, out in enumerate(per):
        coord = (r // m, r % m)
        got = {int(k): v for k, v in json.loads(str(out["results"])).items()}
        assert got == ref["results"], (case["name"], r)
        for rid, want in ref["logits"].items():
            row = out[f"l|{rid}"]
            err = float(np.abs(row - want).max())
            assert err <= LOGIT_TIER * float(np.abs(want).max()), \
                (case["name"], r, rid, err)
        for k, s in json.loads(str(out["params"])).items():
            assert tuple(s) == ref["shapes"][k], (case["name"], r, k)
        names = [k[2:] for k in out if k.startswith("s|")]
        assert sorted(names) == sorted(ref["state"]), case["name"]
        for n in names:
            blk, want = out["s|" + n], ref["state"][n][coord]
            assert blk.shape == want.shape, (case["name"], r, n)
            if n.endswith("/pos"):
                np.testing.assert_array_equal(blk, want, err_msg=n)
            elif n.endswith(("/k", "/v")):
                pos = out["s|" + n[:-1] + "pos"]
                live = (pos >= 0).reshape(pos.shape
                                          + (1,) * (blk.ndim - pos.ndim))
                err = float(np.abs(np.where(live, blk - want, 0)).max())
                top = float(np.abs(np.where(live, want, 0)).max()) or 1.0
                assert err <= KV_TIER * top, (case["name"], r, n, err)
        n_live += _check_live_states(case, ref["snap"], out, coord, r)
    assert n_live or not ref["snap"]["state"], case["name"]
    check_tp_census(case, per)


def _blocks(n: int, m: int, r: int) -> tuple:
    """[lo, hi) of block r of n split in blocks of ceil(n / m)."""
    b = -(-n // m)
    return min(r * b, n), min((r + 1) * b, n)


def _census(out) -> dict:
    import json
    return {k: [json.loads(v) for v in vs]
            for k, vs in json.loads(str(out["census"])).items()}


def check_tp_census(case: dict, per: list) -> None:
    """Hold each rank's ``serve_census`` of ``case`` (its mesh's "model"
    rank r of M) against the split the JAX constrainer's "serve" rules
    give: every attention call at q heads [lo, hi) of ceil(H / M) and the
    kv heads they read, every dense FFN at its ceil(F / M) block of d_ff
    and summed over "model" by one collective where that is not all of
    it, every unembedding at its ceil(V / M) block (each whole where the dim
    is smaller than M), the RG-LRU channels and SSD heads at w / M and
    nh / M where the layer's state is cut over "model"; every step on
    the same weight bytes. Without expert parallelism, on an arch of
    attention and FFN layers: the ranks of a data row run on the whole
    model's bytes of the split leaves once, and of every other leaf
    each (nothing of a split leaf is gathered to more than its rank)."""
    from repro_torch.models import registry, stack
    cfg = serve_case_config(registry, case)
    D, M = case["mesh"]
    H, KH, G = cfg.n_heads, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    tp_axes = ("q_heads", "kv_heads", "mlp", "vocab")
    split = unsplit = 0
    for spec in stack.flat_param_specs(cfg).values():
        n = 4 * int(np.prod(spec.shape))  # f32 params
        if any(a in tp_axes for a in spec.axes) and \
                "expert" not in spec.axes:
            split += n
        else:
            unsplit += n
    rows = {}
    for rank, out in enumerate(per):
        r = rank % M
        cen = _census(out)

        def blk(n):
            lo, hi = _blocks(n, M, r) if n >= M else (0, n)
            return hi - lo
        q = _blocks(H, M, r) if H >= M else (0, H)
        reads = sorted({h // G for h in range(*q)})
        kv = reads[-1] + 1 - reads[0] if reads else 0
        for got in cen["attn"]:
            assert got == [q[1] - q[0], kv], (case["name"], rank, got)
        assert cen["ffn"] in ([], [blk(cfg.d_ff)]), (case["name"], rank)
        # a split FFN sums its partial product over "model", once a call
        assert cen["ffn_sums"] in ([], [int(blk(cfg.d_ff) < cfg.d_ff)]), \
            (case["name"], rank, cen["ffn_sums"])
        assert cen["vocab"] == [blk(cfg.vocab_size)], (case["name"], rank)
        cut = model_cut_leaves(case)
        for key, n, leaf in (("rglru", cfg.lru_width, "/lru"),
                             ("ssd", cfg.ssm_heads, "/ssm")):
            if not cen[key]:
                continue
            assert set(cen[key]) <= {n // M, n}, (case["name"], rank, key)
            if any(k.endswith(leaf) for k in cut):
                assert n // M in cen[key], (case["name"], rank, key)
        assert len(cen["weights"]) == 1, (case["name"], rank)
        rows.setdefault(rank // M, []).append(cen["weights"][0])
    if case["sc"].get("ep") or any(s.mixer in ("rglru", "ssd")
                                   for s in cfg.layer_layout()):
        return
    for row in rows.values():
        assert sum(row) == split + M * unsplit, (case["name"], row)


def _check_live_states(case: dict, snap: dict, out: dict, coord,
                       rank: int) -> int:
    """Hold a rank's recurrent state blocks at the snapshot
    (:func:`snapshot_live_states`) against the JAX shards on the rows of
    live slots within REC_TIER * max; returns how many rows it held."""
    from repro_torch.models import registry
    from repro_torch.serve import mesh as serve_mesh
    from repro_torch.sharding.rules import MeshShape, block_index, rules_for
    cfg = serve_case_config(registry, case)
    mesh = MeshShape(tuple(case["mesh"]), ("data", "model"))
    held = 0
    for p, live in snap["live"].items():
        np.testing.assert_array_equal(out[f"a|{p}"], live)
    for key, shards in snap["state"].items():
        part, name = key.split("|", 1)
        blk, want = out[f"r|{key}"], shards[coord]
        assert blk.shape == want.shape, (case["name"], rank, key)
        axis = 1 if name.startswith("blocks/") else 0
        live = snap["live"].get(part)
        if live is None:
            live = np.ones(blk.shape[axis] if blk.ndim > axis else 0, bool)
        else:
            specs = serve_mesh.decode_state_specs(
                cfg, mesh, rules_for(cfg, mesh, "serve"), len(live),
                case["sc"]["max_len"])
            i, _ = block_index(specs[name][axis], mesh, rank)
            nb = blk.shape[axis]
            live = live[i * nb:(i + 1) * nb]
        if not live.any():
            continue
        b, w = np.compress(live, blk, axis), np.compress(live, want, axis)
        err = float(np.abs(b.astype(np.float64) - w).max())
        top = float(np.abs(w).max()) or 1.0
        assert err <= REC_TIER * top, (case["name"], rank, key, err)
        held += int(live.sum())
    return held


# ---------------------------------------------------------------------------
# The lockstep server on the serving mesh
# (tests/test_torch_serve_mesh_lockstep.py)
# ---------------------------------------------------------------------------

def lockstep_case_config(registry, case: dict):
    """The smoke config of a lockstep case in either package, at the
    case's capacity factor (``cf``) where it gives one."""
    import dataclasses
    cfg = registry.smoke_config(registry.get_config(case["arch"]))
    if case.get("cf"):
        cfg = dataclasses.replace(cfg, capacity_factor=case["cf"])
    return cfg


def lockstep_case_inputs(case: dict) -> dict:
    """A lockstep case's seed-0 JAX init (every ``xgate`` at XATTN_GATE),
    prompts and random fronts, numpy, by ``p|<path>``, ``prompts`` and
    ``f|<front>``."""
    from repro.models import registry as jreg
    cfg = lockstep_case_config(jreg, case)
    out = {f"p|{k}": (v * 0 + XATTN_GATE if k.endswith("/xgate") else v)
           for k, v in jax_serve_params(case).items()}
    out["prompts"] = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (case["batch"], case["plen"])).astype(np.int32)
    for k, v in fronts_np(cfg, case["batch"], 2).items():
        out[f"f|{k}"] = v
    return out


def lockstep_mesh_worker(rank: int, in_path: str, out_dir: str):
    """One rank of a lockstep-on-a-mesh test (``launch_ranks`` target;
    imports no jax): for each case of ``in_path`` (JSON ``cases`` and
    ``<case>|`` inputs of :func:`lockstep_case_inputs`), the port's
    ``BatchedServer`` on this rank of the case's mesh (f32): prefill and
    ``gen`` - 1 greedy steps, then ``out_dir/<case>_<rank>.npz`` with the
    tokens, the prefill's last-position logits, the param block shapes
    (JSON) and every state block (``s|<leaf>``)."""
    import json

    from repro_torch.core.zebra_mpmd import _unflatten
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry, stack
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.pytree import flatten, params_from_jax
    from repro_torch.serve import BatchedServer, make_serve_program

    torch.set_num_threads(1)
    data = np.load(in_path)
    run = RunConfig(policy=Policy(compute_dtype=torch.float32))
    for case in json.loads(str(data["cases"])):
        name = case["name"]
        pre = f"{name}|"
        mesh = make_mesh(case["mesh"], ("data", "model"), "cpu")
        cfg = lockstep_case_config(registry, case)
        params = params_from_jax(_unflatten(
            {k[len(pre) + 2:]: data[k] for k in data.files
             if k.startswith(pre + "p|")}))
        fronts = {k[len(pre) + 2:]: torch.from_numpy(data[k])
                  for k in data.files if k.startswith(pre + "f|")}
        server = BatchedServer(
            make_serve_program(cfg, run, mesh=mesh, device="cpu"), params,
            case["batch"], case["plen"] + case["gen"])
        toks = [server.submit_prefill(data[pre + "prompts"], fronts)]
        logits = to_np(server.logits)
        toks += [server.step(fronts) for _ in range(case["gen"] - 1)]
        out = {"tokens": to_np(torch.cat(toks, 1)), "logits": logits,
               "params": json.dumps({k: list(v.shape) for k, v in
                                     flatten(server.params).items()})}
        for k, v in stack.state_leaves(server.state).items():
            out[f"s|{k}"] = to_np(v)
        np.savez(f"{out_dir}/{name}_{rank}.npz", **out)


def jax_lockstep_run(case: dict, mesh, inputs: dict) -> dict:
    """The JAX package's lockstep server of ``case`` on ``mesh`` (f32,
    the same inputs): tokens, prefill logits, {path: param shard shape}
    and {leaf: {mesh coords: shard}} of the state."""
    import jax
    import jax.numpy as jnp

    from repro.models import registry as jreg
    from repro.models.config import ShapeConfig
    from repro.models.modules import Policy as JPolicy
    from repro.models.modules import RunConfig as JRun
    from repro.pytree import tree_map_with_path_names
    from repro.serve import BatchedServer as JBatchedServer
    from repro.serve import make_serve_program as jmake_serve
    from repro_torch.core.zebra_mpmd import _unflatten as junflatten

    jcfg = lockstep_case_config(jreg, case)
    run = JRun(policy=JPolicy(compute_dtype=jnp.float32), attn_impl="ref",
               moe_impl="gather")
    B, L = case["batch"], case["plen"] + case["gen"]
    prog = jmake_serve(jcfg, mesh, run, ShapeConfig("t", "decode", L, B),
                       max_len=L)
    params = junflatten({k[2:]: jnp.asarray(v) for k, v in inputs.items()
                         if k.startswith("p|")})
    with mesh:
        params = jax.device_put(params, prog.param_shardings)
    fronts = {k[2:]: jnp.asarray(v) for k, v in inputs.items()
              if k.startswith("f|")}
    server = JBatchedServer(prog, params, B, L)
    prompts = jnp.asarray(inputs["prompts"])
    with mesh:  # BatchedServer.submit_prefill, keeping the logits
        server.state, last = prog.prefill_step(params, server.state,
                                               prompts, fronts)
    server.cache_index = jnp.asarray(case["plen"], jnp.int32)
    server.tokens = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
    toks = [server.tokens] + [server.step(fronts)
                              for _ in range(case["gen"] - 1)]
    coord = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
             for d in mesh.devices.flat}
    shapes, state = {}, {}
    tree_map_with_path_names(lambda n, v: shapes.__setitem__(
        n, tuple(v.sharding.shard_shape(v.shape))), params)
    tree_map_with_path_names(lambda n, v: state.__setitem__(
        n, {coord[s.device.id]: np.array(s.data)
            for s in v.addressable_shards}), server.state)
    return {"tokens": np.asarray(jnp.concatenate(toks, 1)),
            "logits": np.asarray(last), "shapes": shapes, "state": state}


def run_lockstep_mesh(tmp, mesh, world: int, cases: list) -> tuple:
    """The port's ranks (:func:`lockstep_mesh_worker`) beside the JAX
    servers on ``mesh`` (:func:`run_beside_jax`): ({case: JAX run},
    {case: [rank outputs]}, {case: inputs})."""
    inputs = {c["name"]: lockstep_case_inputs(c) for c in cases}
    ref, per = run_beside_jax(
        tmp, world, lockstep_mesh_worker, cases,
        {f"{n}|{k}": v for n, d in inputs.items() for k, v in d.items()},
        lambda c: jax_lockstep_run(c, mesh, inputs[c["name"]]))
    return ref, per, inputs


def check_lockstep_mesh(case: dict, ref: dict, per: list) -> None:
    """Every rank's tokens equal JAX's; its prefill logits within
    LOGIT_TIER * max; its param and state block shapes equal the JAX
    shards at its coordinate; its KV blocks within KV_TIER * max on the
    lines whose position is >= 0 (positions equal)."""
    import json
    m = case["mesh"][1]
    for r, out in enumerate(per):
        coord = (r // m, r % m)
        np.testing.assert_array_equal(out["tokens"], ref["tokens"])
        err = float(np.abs(out["logits"] - ref["logits"]).max())
        assert err <= LOGIT_TIER * float(np.abs(ref["logits"]).max()), \
            (case["name"], r, err)
        for k, s in json.loads(str(out["params"])).items():
            assert tuple(s) == ref["shapes"][k], (case["name"], r, k)
        names = sorted(k[2:] for k in out if k.startswith("s|"))
        assert names == sorted(ref["state"]), case["name"]
        for n in names:
            blk, want = out["s|" + n], ref["state"][n][coord]
            assert blk.shape == want.shape, (case["name"], r, n)
            if n.endswith("/pos"):
                np.testing.assert_array_equal(blk, want, err_msg=n)
            else:
                pos = out["s|" + n[:-1] + "pos"]
                live = (pos >= 0).reshape(pos.shape
                                          + (1,) * (blk.ndim - pos.ndim))
                err = float(np.abs(np.where(live, blk - want, 0)).max())
                top = float(np.abs(np.where(live, want, 0)).max()) or 1.0
                assert err <= KV_TIER * top, (case["name"], r, n, err)


# ---------------------------------------------------------------------------
# The zebra MPMD engine across ranks (tests/test_torch_zebra_mpmd_ranks.py)
# ---------------------------------------------------------------------------

def mpmd_named(grads_attn) -> dict:
    """{name: leaf} of a ``grads_attn`` tree: the non-layer paths, and
    ``layers/<l>/<path>`` for each layer."""
    from repro_torch.pytree import flatten
    out = flatten({k: v for k, v in grads_attn.items() if k != "layers"})
    for l, layer in enumerate(grads_attn["layers"]):
        out.update({f"layers/{l}/{k}": v for k, v in flatten(layer).items()})
    return out


def mpmd_case_config(registry, case):
    """The 2-layer smoke W1 of the MPMD tests (capacity factor 99, the
    engine's ``cf`` when a case gives one)."""
    import dataclasses
    return dataclasses.replace(
        registry.smoke_config(registry.get_config("mixtral-w1")),
        n_layers=2, capacity_factor=99.0)


def mpmd_rank_worker(rank: int, in_path: str, out_dir: str):
    """One rank of a rank-mode MPMD test (``launch.mesh.launch_ranks``
    target; imports no jax). ``in_path``: an npz of the cases (JSON, all at
    one M x N), the JAX init (``p|<path>``) and the batches
    (``tokens|<B>``, ``targets|<B>``). For each case: the engine on this
    rank, one step, then ``out_dir/<case>_<rank>.npz`` with the loss, the
    gradients (``g|<name>`` on an attention rank, ``e|<l>|<key>`` on a
    lane), an attention rank's routed counts and capacity of each (layer,
    microbatch) (``routed|<l>|<j>``, ``C``), the bytes this rank sent in
    each hop (``hop|<kind>|<l>|<j>``), a lane's forward chunk inputs in
    call order (``chunk|<n>``) and, for a case with ``trace``, rank 0's
    spans of a second, traced step (``spans``). Each rank asserts its
    bytes a hop: an attention rank's are its kept rows of the remote
    experts (both tensors in C(B)), a lane's at most its experts' share
    E_lane C d of the reference's hop."""
    import json

    from repro_torch.core import zebra_mpmd_ranks as zr
    from repro_torch.core.zebra_mpmd import _unflatten
    from repro_torch.models import registry
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.obs import trace as obs_trace
    from repro_torch.pytree import params_from_jax

    torch.set_num_threads(1)
    data = np.load(in_path)
    cases = json.loads(str(data["cases"]))
    run = RunConfig(policy=Policy(compute_dtype=torch.float32))
    groups = zr.RankGroups(cases[0]["M"], cases[0]["N"], "cpu")
    params = params_from_jax(_unflatten({k[2:]: data[k] for k in data.files
                                         if k.startswith("p|")}))
    for case in cases:
        cfg = mpmd_case_config(registry, case)
        eng = zr.ZebraMPMDRanks(
            cfg, run, groups, num_microbatches=2,
            offload=tuple(case["offload"]) if case["offload"] else None,
            capacity_factor=case["cf"], n_chunks=case["Q"])
        attn_side, exp_layers = eng.shard_params(params)
        chunks = []
        if groups.role == "lane":
            fwd = eng.expert_fwd

            def recording(p, buf, fwd=fwd, own=[l[0] for l in exp_layers]):
                if any(p is o for o in own):
                    chunks.append(to_np(buf).copy())
                return fwd(p, buf)
            eng.expert_fwd = recording
        B = case["batch"]
        batch = (torch.from_numpy(data[f"tokens|{B}"].copy()),
                 torch.from_numpy(data[f"targets|{B}"].copy()))
        loss, ga, ge = eng.train_step(attn_side, exp_layers, *batch)
        out = {"loss": to_np(loss)}
        d, size = cfg.d_model, 4
        for (kind, l, j), n in eng.hop_bytes.items():
            out[f"hop|{kind}|{l}|{j}"] = n
            if groups.role == "attn":
                counts, a = eng.routed[(l, j)], groups.index
                C = eng.capacity(B // 2 * batch[0].shape[1])[0]
                n_att = eng.plan.n_attn_experts(l)
                kept = [max(0, min(C - sum(c[e] for c in counts[:a]),
                                   counts[a][e]))
                        for e in range(n_att, cfg.n_experts)]
                assert n == sum(kept) * d * size * (2 if kind == "B" else 1)
            else:
                C = eng.capacity(B // 2 * batch[0].shape[1])[0]
                assert n <= eng.lane_experts(l) * C * d * size
        if ga is not None:
            out.update({f"g|{k}": to_np(v) for k, v in mpmd_named(ga).items()})
            out.update({f"routed|{l}|{j}": np.array(c)
                        for (l, j), c in eng.routed.items()})
        else:
            out.update({f"e|{l}|{k}": to_np(v) for l, lane in enumerate(ge)
                        for k, v in lane[0].items()})
            out.update({f"chunk|{n}": c for n, c in enumerate(chunks)})
        if case.get("trace"):
            with obs_trace.use(obs_trace.Tracer()) as tr:
                eng.train_step(attn_side, exp_layers, *batch)
            out["spans"] = json.dumps(sorted(
                [ev.name, sorted(ev.args.items())] for ev in tr.events
                if ev.track == "zebra-mpmd" and ev.ph == "B"))
        np.savez(f"{out_dir}/{case['name']}_{rank}.npz", **out)
