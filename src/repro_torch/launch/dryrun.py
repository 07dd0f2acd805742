"""Dry run of every (arch x shape x mesh) cell on fake ranks (mirror of
``repro/launch/dryrun.py``).

Proves without hardware that a cell's program holds together at
production scale, and reports what one GPU needs for it: rank 0 of the
16x16 single-pod or 2x16x16 multi-pod mesh (``make_production_mesh``)
runs the port's own step once, on a process group of the fake backend
(``torch.testing._internal.distributed.fake_pg``: every collective is
called, none moves data) under ``FakeTensorMode`` (shapes, dtypes and
strides, no data, nothing allocated), at full width and full depth:

* train cells run ``train/step.py``'s ``make_train_program`` on the mesh
  (zebra for the MoE archs, as the JAX dry run compiles it; one stream):
  one forward, one backward, one AdamW update;
* prefill and decode cells run the lockstep ``serve/engine.py``
  ``make_serve_program(mesh=)`` with its state at the shape's batch and
  ``seq_len`` (decode writes the cache's last line).

The hand-written kernels on the path take their fake route
(``kernels/_build.py``): the card's route, design and row tile, their
outputs allocated, their calls and work recorded in
``_build.FAKE_WORK``, nothing built or launched. Fake tensors stand for
tensors on the card whatever device they name; they name the CPU
(``TRACE_DEVICE``), because a CPU-only torch cannot record autograd on
fake CUDA tensors, so the same trace runs on a host with a card and on
one without.

What one step of rank 0 costs, counted as it runs (:class:`Accounts`):

* ``flops_per_device``: every op's FLOPs by ``torch.utils.flop_counter``'s
  formulas, plus each kernel's own math (2·M·K·N a product over the rows
  it computes, padded tiles included);
* ``hbm_bytes_per_device``: the bytes every op and kernel call reads and
  writes (views and empty allocations none), the unfused counterpart of
  XLA's "bytes accessed" and so an upper bound (``hbm_bytes_kind``);
* memory: ``arg_bytes_per_device`` (params, optimizer state and batch;
  a serving cell's compute-dtype params, its state and inputs),
  ``temp_bytes_per_device`` (the peak of every other storage the step
  made live), ``output_bytes_per_device`` (the new storages it returns,
  inside that peak), ``total_bytes_per_device`` = arg + temp, judged
  against the H100's memory (``fits_80gb``);
* collectives (``launch/mesh_comm.py``'s ``Counter``, tallied in the JAX
  package's buckets by ``launch/hlo_analysis.py``) and the roofline at the
  H100's peaks;
* ``launches``: the kernel calls the step made, by kernel and by design
  (``_build.fake_calls``): the launches the card's step makes.

There is no loop over layers to extrapolate: every layer runs, so the
counts are exact. Numbers are accounts of fake tensors, not timings.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun.csv
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.inputs import input_specs
from repro_torch.core import hardware as HW
from repro_torch.core.zebra_spmd import ZebraConfig
from repro_torch.launch.hlo_analysis import (Roofline, collective_bytes,
                                             slowest_link)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.mesh_comm import Counter
from repro_torch.models import registry, stack
from repro_torch.models.config import SHAPES
from repro_torch.models.modules import Policy, RunConfig
from repro_torch.serve.engine import make_serve_program
from repro_torch.sharding.rules import local_shape

TRACE_DEVICE = "cpu"
HBM_BYTES_KIND = ("unfused: each op's and kernel call's tensors read and "
                  "written once, an upper bound of the fused program's")
_A = torch.ops.aten
# How an op's bytes count (see Accounts): an empty allocation moves none
# (nor ``_unsafe_view``, a view its schema does not mark);
# a gather reads the rows it returns (and its indices), not its whole
# source; an in-place scatter reads its values and writes as many.
_EMPTY = {_A.empty, _A.empty_strided, _A.empty_like, _A.new_empty,
          _A.new_empty_strided, _A._unsafe_view}  # the last: a view
_GATHER = {_A.index, _A.index_select, _A.embedding, _A.gather}
_SCATTER = {_A.index_put_, _A._index_put_impl_, _A.index_add_,
            _A.scatter_add_, _A.scatter_, _A.index_copy_}


def model_flops(cfg, shape) -> float:
    """Analytical 'useful' FLOPs per step: 6*N_active*tokens (train),
    2*N_active*tokens (prefill/decode)."""
    n = cfg.active_param_count()
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * shape.tokens


def storages_nbytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = (st, st.nbytes())
    return sum(n for _, n in seen.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Accounts(TorchDispatchMode):
    """One pass over every op a step dispatches: FLOPs, bytes read and
    written, and the live bytes of the storages the step makes (their
    peak), the storages of ``known`` (the step's arguments) excepted.
    ``costs=False`` keeps the memory only.

    FLOPs: ``torch.utils.flop_counter``'s formulas; an op without one that
    has a composite definition (``matmul`` and ``einsum`` reach the mode
    whole under ``inference_mode``) is counted through its decomposition,
    as ``FlopCounterMode`` does. Bytes: each distinct tensor argument read
    once and each output that is not an argument written once; views,
    metadata queries and empty allocations move none, a gather reads the
    rows it returns, an in-place scatter reads its values and writes as
    many (``_GATHER``, ``_SCATTER``)."""

    def __init__(self, known=(), costs: bool = True):
        super().__init__()
        self.costs = costs
        self.flops = self.bytes = self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in tree_leaves(known):
            if isinstance(t, torch.Tensor):
                self._seen[t.untyped_storage()] = 0
        self._info = {}

    def _meta(self, func):
        """(bytes rule, flop formula, decomposes, makes storage) of
        ``func``: an op whose returns all alias an argument (a view, an
        in-place op, a collective) makes no storage."""
        m = self._info.get(func)
        if m is None:
            pk, rets = func.overloadpacket, func._schema.returns
            view = bool(rets) and all(
                r.alias_info is not None and not r.alias_info.is_write
                for r in rets)
            fresh = any(r.alias_info is None for r in rets)
            prim = func.namespace == "prim"
            rule = ("none" if view or prim or pk in _EMPTY else
                    "gather" if pk in _GATHER else
                    "scatter" if pk in _SCATTER else "all")
            flop = flop_registry.get(pk)
            comp = flop is None and not prim and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd")
            m = self._info[func] = (rule, flop, comp, fresh)
        return m

    def _free(self, n: int):
        self.live -= n

    def _count_bytes(self, rule, args, kwargs, outs):
        ins = {id(t): t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        if rule == "gather":
            return sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins.values()
                if not t.is_floating_point())
        if rule == "scatter":
            return 2 * sum(_nbytes(t) for t in list(ins.values())[1:])
        return sum(_nbytes(t) for t in ins.values()) + sum(
            _nbytes(t) for t in outs if id(t) not in ins)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule, flop, comp, fresh = self._meta(func)
        if comp and self.costs:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not (fresh or (self.costs and rule != "none")):
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if self.costs:
            if flop is not None:
                self.flops += flop(*args, **kwargs, out_val=out)
            if rule != "none":
                self.bytes += self._count_bytes(rule, args, kwargs, outs)
        if not fresh:
            return out
        for t in outs:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)
        return out


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank ``rank`` of a ``world``-rank process group on
    the fake backend (collectives called, no data moved), torn down on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_params(cfg, specs: dict, mesh, dtype):
    """The param tree of ``cfg`` as this rank's blocks under ``specs``
    ({path: fitted spec}), fake tensors of ``dtype`` (call under
    ``FakeTensorMode``)."""
    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = walk(v, path)
                continue
            shape = tuple(v.shape)
            if path in specs:
                shape = local_shape(specs[path], shape, mesh)
            out[k] = torch.empty(shape, dtype=dtype, device=TRACE_DEVICE)
        return out
    return walk(stack.param_specs(cfg), "")


def fake_inputs(specs: dict) -> dict:
    """Fake tensors of :func:`configs.inputs.input_specs`'s specs."""
    return {k: torch.empty(s.shape, dtype=s.dtype, device=TRACE_DEVICE)
            for k, s in specs.items()}


def _where(exc) -> str:
    """file:line of the port's innermost frame in ``exc``'s traceback."""
    at = ""
    for fr in traceback.extract_tb(exc.__traceback__):
        if f"{os.sep}repro_torch{os.sep}" in fr.filename:
            rel = fr.filename.split(f"{os.sep}repro_torch{os.sep}")[-1]
            at = f" at {rel}:{fr.lineno}"
    return at


def _mesh_of(multi_pod: bool, mesh_shape):
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")
    return tuple(mesh_shape), axes, "x".join(map(str, mesh_shape))


def _train_step(cfg, shape, mesh, run, zcfg):
    """(step, args, program): the train program's step on fake args."""
    from repro_torch.train.step import make_train_program
    z = zcfg if cfg.is_moe else None
    program = make_train_program(cfg, run, shape, device=TRACE_DEVICE,
                                 mesh=mesh, zcfg=z, zebra_streams=False)
    lay = program.layout
    params = fake_params(cfg, lay.param_specs, mesh, run.policy.param_dtype)
    opt_state = program.init_opt(params)
    batch = fake_inputs(input_specs(cfg, shape, run.policy.compute_dtype))
    return (lambda: program.train_step(params, opt_state, batch),
            {"params": params, "opt": opt_state, "batch": batch}, program)


def _serve_step(cfg, shape, mesh, run):
    """(step, args, program): the lockstep server's prefill or decode step
    on fake args, its state at the shape's batch and seq_len."""
    sp = make_serve_program(cfg, run, mesh=mesh, device=TRACE_DEVICE)
    B, L = shape.global_batch, shape.seq_len
    lay = sp.layout(B, L)
    params = stack.compute_params(
        fake_params(cfg, lay.param_specs, mesh, run.policy.param_dtype),
        run.policy)
    state = sp.init_state(B, L)
    inputs = fake_inputs(input_specs(cfg, shape, run.policy.compute_dtype))
    tokens = inputs.pop("tokens")
    if shape.kind == "prefill":
        def step():
            return sp.prefill_step(params, state, tokens, inputs)
    else:
        def step():
            return sp.decode_step(params, state, tokens, L - 1, inputs)
    return step, {"params": params, "state": state, "tokens": tokens,
                  "fronts": inputs}, sp


def _trace(cfg, shape, mesh, run, zcfg, costs: bool) -> dict:
    """One step of ``mesh``'s rank on fake args (call under
    ``FakeTensorMode``): the record's accounts."""
    from repro_torch.kernels import _build
    if shape.kind == "train":
        step, args, program = _train_step(cfg, shape, mesh, run, zcfg)
    else:
        step, args, program = _serve_step(cfg, shape, mesh, run)
    _build.reset_fake_work()
    acc = Accounts(known=args, costs=costs)
    counter = Counter()
    t0 = time.perf_counter()
    try:
        counter.on = True
        with acc:
            out = step()
    finally:
        counter.close()
    trace_s = time.perf_counter() - t0
    held = {id(t.untyped_storage()) for t in tree_leaves(args)
            if isinstance(t, torch.Tensor)}
    out_bytes = storages_nbytes(
        [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
         and id(t.untyped_storage()) not in held])
    arg_bytes = storages_nbytes(args)
    rec = {"status": "ok"}
    if costs:
        work = {k: {**v, "designs": dict(v["designs"])}
                for k, v in _build.FAKE_WORK.items()}
        kflops = sum(w["flops"] for w in work.values())
        rec.update(flops_per_device=acc.flops + kflops,
                   kernel_flops_per_device=kflops,
                   hbm_bytes_per_device=acc.bytes + sum(
                       w["bytes"] for w in work.values()),
                   hbm_bytes_kind=HBM_BYTES_KIND, kernel_work=work)
    coll = collective_bytes(counter.counts)
    link = slowest_link(mesh)
    rec.update({
        "collective_bytes_per_device": coll["total"],
        "ring_collective_bytes_per_device": coll["ring_total"],
        "t_collective_ring_s": coll["ring_total"] / link,
        "coll_breakdown": {k: v for k, v in coll.items()
                           if k not in ("total", "ring_total") and v},
        "collective_calls": {k: c["calls"]
                             for k, c in counter.counts.items()},
        "arg_bytes_per_device": arg_bytes,
        "temp_bytes_per_device": acc.peak,
        "output_bytes_per_device": out_bytes,
        "total_bytes_per_device": arg_bytes + acc.peak,
        "fits_80gb": arg_bytes + acc.peak < HW.H100_MEMORY_BYTES,
    })
    if shape.kind == "train":
        rec.update(param_bytes_per_device=storages_nbytes(args["params"]),
                   opt_bytes_per_device=storages_nbytes(args["opt"]),
                   zebra=(dataclasses.asdict(program.zcfg)
                          if program.zcfg is not None and cfg.is_moe
                          else None))
    rec.update(launches=_build.fake_calls(), peak_flops=HW.H100_PEAK_FLOPS,
               hbm_bw=HW.H100_HBM_BW, link_bw=link, trace_s=trace_s)
    return rec


def lower_cell(arch: str, shape_name, *, multi_pod: bool,
               zebra_mode: str = "alltoall", microbatches: int = 4,
               remat: str = "full", costs: bool = True, mesh_shape=None,
               rank: int = 0, cfg=None) -> dict:
    """Trace one cell on rank ``rank`` of fake ranks; returns its record.
    ``shape_name``: a name of ``SHAPES`` or a ``ShapeConfig``;
    ``mesh_shape`` (None: the production mesh of ``multi_pod``) and
    ``cfg`` (a config of ``arch`` in place of the registry's, e.g. its
    smoke config) size a cell down."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or registry.get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mshape, axes, mesh_name = _mesh_of(multi_pod, mesh_shape)
    head = {"arch": arch, "shape": shape.name, "mesh": mesh_name}
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return {**head, "status": "skipped",
                "reason": "full attention at 524k is O(s^2) - per brief"}
    run = RunConfig(policy=Policy(param_dtype=torch.float32),
                    attn_impl="chunked", moe_impl="gather", remat=remat)
    zcfg = ZebraConfig(mode=zebra_mode, num_microbatches=microbatches)
    n_dev = 1
    for n in mshape:
        n_dev *= n
    with fake_world(n_dev, rank):
        mesh = make_mesh(mshape, axes, TRACE_DEVICE)
        with FakeTensorMode():
            rec = _trace(cfg, shape, mesh, run, zcfg, costs)
    mf = model_flops(cfg, shape)
    rec = {**head, "n_devices": n_dev, "rank": rank, **rec,
           "model_flops": mf}
    if costs:
        rec.update(Roofline(
            flops_per_device=rec["flops_per_device"],
            hbm_bytes_per_device=rec["hbm_bytes_per_device"],
            collective_bytes_per_device=rec["collective_bytes_per_device"],
            n_devices=n_dev, model_flops=mf,
            link_bw=rec["link_bw"]).row())
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--zebra-mode", default="alltoall",
                    choices=["alltoall", "replicated"])
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--remat", default="full",
                    choices=["none", "dots", "full"])
    ap.add_argument("--no-costs", action="store_true",
                    help="skip the FLOP and byte counts (memory only)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED
    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records = []
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                t0 = time.time()
                try:
                    rec = lower_cell(arch, shape, multi_pod=multi,
                                     zebra_mode=args.zebra_mode,
                                     microbatches=args.microbatches,
                                     remat=args.remat,
                                     costs=not args.no_costs)
                except Exception as e:  # a failure here is a port fault
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if multi else "16x16",
                           "status": f"FAIL: {type(e).__name__}: "
                                     f"{str(e)[:300]}{_where(e)}"}
                rec["wall_s"] = round(time.time() - t0, 1)
                records.append(rec)
                print(json.dumps(rec), flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        keys = sorted({k for r in records for k in r})
        with open(args.out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            for r in records:
                w.writerow({k: (json.dumps(v) if isinstance(v, dict) else v)
                            for k, v in r.items()})
    n_ok = sum(r.get("status") == "ok" for r in records)
    n_skip = sum(r.get("status") == "skipped" for r in records)
    print(f"\n[dryrun] ok={n_ok} skipped={n_skip} "
          f"failed={len(records) - n_ok - n_skip}", file=sys.stderr)
    return 0 if n_ok + n_skip == len(records) else 1


if __name__ == "__main__":
    sys.exit(main())
