"""Shared helpers of the ``test_torch_*`` parity tests (not a test module).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs as its own tests run it on the CPU (Pallas kernels in
interpret mode, ``Policy(compute_dtype=float32)``), the port runs the
plain versions of its kernels (CPU tensors).
"""

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
    trace of ``in_path``, joins a gloo group through ``init_file`` and
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
    group = EPGroup(dist.group.WORLD)
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
            cfg, run, sc, device="cpu", ep_group=group,
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


def mesh_program(case, mesh):
    """The port's mesh program of a test case (f32 policy, chunked
    attention in two query chunks, full remat)."""
    from repro_torch.core.zebra_spmd import ZebraConfig
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.modules import Policy, RunConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_program

    cfg = registry.smoke_config(registry.get_config(case["arch"]))
    run = RunConfig(policy=Policy(compute_dtype=torch.float32),
                    attn_impl="chunked", moe_impl="gather", remat="full",
                    chunk_q=16)
    z = case.get("zcfg")
    return cfg, make_train_program(
        cfg, run, ShapeConfig("t", "train", MESH_S, MESH_B),
        opt_cfg=mesh_opt_cfg(opt), device="cpu", mesh=mesh,
        zcfg=None if z is None else ZebraConfig(capacity_factor=1.25, **z),
        accum_steps=case.get("accum", 1))


def mesh_train_worker(rank: int, in_path: str, out_dir: str):
    """One rank of a mesh-program test (``launch.mesh.launch_ranks``
    target; imports no jax). ``in_path``: an npz of the cases (JSON), the
    token file's path and the JAX init of each arch (``<arch>|<path>``).
    For each case: the mesh, this rank's blocks of the init, five steps on
    the global batches, then ``out_dir/<case>_<rank>.npz`` with the
    metrics, the final blocks (``p|<path>``), the param and moment block
    shapes, the params' specs and the zebra engine's dropped share. A
    case with ``save`` also checkpoints after that step (``ckpt`` dir,
    blocking) and a case with ``restore`` starts from that step of its
    ``ckpt`` dir (the restored blocks saved as ``r|params/<path>``,
    ``r|opt/...``)."""
    import json

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import zebra_spmd
    from repro_torch.data import DataConfig, DataLoader
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.pytree import flatten

    torch.set_num_threads(1)
    data = np.load(in_path)
    for case in json.loads(str(data["cases"])):
        mesh = make_mesh(case["mesh"], ("data", "model"), "cpu")
        cfg, prog = mesh_program(case, mesh)
        lay = prog.layout
        params = {}
        for path in lay.shapes:
            full = torch.from_numpy(data[f"{case['arch']}|{path}"].copy())
            node = params
            *parents, leaf = path.split("/")
            for q in parents:
                node = node.setdefault(q, {})
            node[leaf] = lay.local(path, full).clone()
        state = prog.init_opt(params)
        loader = DataLoader(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=MESH_S, global_batch=MESH_B,
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
        hist = []
        for step in range(start, MESH_STEPS):
            params, state, m = prog.train_step(params, state, next(loader))
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
                 specs=json.dumps(lay.param_specs), **restored,
                 **{f"p|{k}": to_np(v) for k, v in flat.items()})
