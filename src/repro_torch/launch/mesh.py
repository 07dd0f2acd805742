"""Device meshes over the running process group (mirror of
``repro/launch/mesh.py``), and the launcher of one process per rank.

A :class:`Mesh` is a ``torch.distributed.device_mesh.DeviceMesh`` over
``("data", "model")`` (or ``("pod", "data", "model")``) plus the process
group of every set of its axes, so a collective "over data" or "over
(data, model)" names its group. Rank r is the mesh coordinate JAX gives
its r-th device: row-major, ``(r // M, r % M)`` on a D x M mesh. NCCL on
``cuda`` (rank r on ``cuda:r``), gloo on ``cpu``.

:func:`launch_ranks` starts one process per rank through
``torch.multiprocessing`` with a ``file://`` rendezvous in a temporary
directory; under ``torchrun`` (RANK and WORLD_SIZE set) the process joins
the existing group instead. A CUDA world larger than the cards present is
refused (:class:`WorldTooLarge`); nothing falls back to the CPU.
"""

from __future__ import annotations

import itertools
import os
import tempfile
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import MeshShape, coords


class WorldTooLarge(RuntimeError):
    pass


def backend_for(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def parse_mesh(text: str, flag: str = "--mesh", form: str = "DxM") -> tuple:
    """"DxM" -> (D, M); ``flag`` and ``form`` name the option in errors."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"{flag} {text!r}: expected {form}") from None
    if d < 1 or m < 1:
        raise ValueError(f"{flag} {text!r}: sizes must be >= 1")
    return d, m


class Mesh(MeshShape):
    """A DeviceMesh over the default process group, with the process group
    of every set of its axes of size > 1 (:meth:`group`)."""

    def __init__(self, shape, axes, device_type: str):
        super().__init__(shape, axes)
        from torch.distributed.device_mesh import init_device_mesh
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {dict(self.shape)} needs {self.size} "
                             f"ranks; the process group has {world}")
        self.rank = dist.get_rank()
        self.device_type = device_type
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if device_type == "cuda" else torch.device("cpu"))
        self.coords = coords(self, self.rank)
        self.device_mesh = init_device_mesh(
            device_type, tuple(self.shape.values()),
            mesh_dim_names=self.axis_names)
        live = tuple(a for a in self.axis_names if self.shape[a] > 1)
        self._groups = {}
        for r in range(1, len(live) + 1):
            for sub in itertools.combinations(live, r):
                self._groups[sub] = self._new_group(sub, len(live))

    def _new_group(self, sub, n_live):
        if len(sub) == n_live:
            return dist.group.WORLD
        if len(sub) == 1:
            return self.device_mesh.get_group(sub[0])
        # every class of ranks equal off ``sub``, made on every rank in
        # one order; this rank keeps its own
        mine = None
        others = [a for a in self.axis_names if a not in sub]
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            ranks = [r for r in range(self.size)
                     if all(coords(self, r)[a] == v
                            for a, v in zip(others, fixed))]
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def group(self, axes):
        """The process group over ``axes`` (names, or None / ()), None
        when their sizes multiply to 1."""
        axes = () if axes is None else \
            ((axes,) if isinstance(axes, str) else tuple(axes))
        key = tuple(a for a in self.axis_names
                    if a in axes and self.shape[a] > 1)
        return self._groups[key] if key else None


def make_mesh(shape, axes, device: str = "cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` on the running process group."""
    return Mesh(tuple(shape), tuple(axes), torch.device(device).type)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> Mesh:
    """Single pod: 16x16 (data, model); multi-pod: 2x16x16 (pod, data,
    model), the pod axis pure data parallelism. Built only where that many
    ranks run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def _init_rank(rank: int, world: int, device: str, init_method: str):
    if torch.device(device).type == "cuda":  # torchrun: the host's index
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend_for(device), init_method=init_method,
                            rank=rank, world_size=world)


def _rank_entry(rank: int, fn: Callable, world: int, device: str,
                init_method: str, args: tuple):
    _init_rank(rank, world, device, init_method)
    try:
        fn(rank, *args)
        if world > 1:  # no rank tears its links down under another's
            dist.barrier()
    finally:
        dist.destroy_process_group()


def launch_ranks(fn: Callable, world: int, device: str, *args) -> None:
    """Run ``fn(rank, *args)`` on ``world`` ranks, each with the default
    process group initialized (NCCL on ``cuda``, rank r on ``cuda:r``;
    gloo on ``cpu``). One rank runs in this process; more are spawned
    (``fn`` must be importable by name) and a rank that fails raises here.
    Under ``torchrun`` this process is one rank of an existing world."""
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if world > have:
            raise WorldTooLarge(f"a {world}-rank mesh needs {world} CUDA "
                                f"devices; {have} present")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if n != world:
            raise ValueError(f"torchrun world {n} != mesh size {world}")
        _rank_entry(rank, fn, world, device, "env://", args)
        return
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        if world == 1:
            _rank_entry(0, fn, 1, device, init, args)
            return
        import torch.multiprocessing as mp
        mp.spawn(_rank_entry, args=(fn, world, device, init, args),
                 nprocs=world, join=True)
