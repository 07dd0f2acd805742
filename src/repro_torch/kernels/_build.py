"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds, not minutes. All sources compile in parallel (one ``nvcc``
each, all started together). Libraries land in
``<repo>/build/repro_torch_kernels/<hash>/``, keyed by a hash of the
sources and flags, so an edited kernel rebuilds and an unchanged one is
reused. Nothing is built at import: the first kernel launch builds.

Fake tensors (``FakeTensorMode``: shapes, dtypes and strides, no data;
the dry run's trace, ``launch/dryrun.py``) stand for tensors on the card,
whatever device they name: a wrapper given fake tensors (:func:`fake`)
takes the card's route, design and plan with its checks, allocates its
outputs and adds the call and the kernel's work to ``FAKE_WORK``
(:func:`record_fake`), but launches nothing, reads no pointer, builds
nothing and leaves the wrappers' launch counts alone: those count only
launches on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

from torch._subclasses.fake_tensor import FakeTensor

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# Shared memory one block can use on Hopper (227 KB, dynamic): the bound
# of the tensor-core kernels' plans.
SMEM_PER_BLOCK = 232448


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build_all() -> float:
    """Compile every missing library. Returns the seconds spent (0.0 when
    all libraries were already built). Raises with nvcc's output if any
    source fails; every nvcc process is waited for either way."""
    out_dir = build_dir()
    todo = [s for s in sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, building first if needed."""
    build_all()
    return ctypes.CDLL(str(build_dir() / f"lib{name}.so"))


# The calls the fake routes stood in for since the last reset, by kernel:
# calls, calls by design (``"wgmma"``, ``"fma"``, ...; none for a kernel
# of one design), FLOPs of the math (2·M·K·N a product, over every row a
# kernel computes, padded tiles included; not the bf16 terms of an f32
# split) and bytes (each input read once, each output written once).
FAKE_WORK: dict = {}


def fake(t) -> bool:
    """True when ``t`` is a fake tensor: its wrapper takes the fake route.
    (``fake_tensor.is_fake`` also unwraps tensor subclasses, which no
    wrapper is given, at 1.6 µs a call; this test takes 0.2 µs.)"""
    return isinstance(t, FakeTensor)


def address(t) -> int:
    """``t.data_ptr()``, or for a fake tensor the byte offset of its view
    in its storage (a storage on the card starts 256-byte aligned): what
    the kernels' alignment checks read."""
    if isinstance(t, FakeTensor):
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def record_fake(name: str, design, flops: int, inputs, outputs,
                read: int = 0) -> None:
    """Add one fake call of kernel ``name`` in ``design`` (None: the
    kernel has one) to ``FAKE_WORK``: its ``inputs`` read and ``outputs``
    written whole, and ``read`` bytes more (what a kernel reads of a
    tensor it does not read whole)."""
    w = FAKE_WORK.setdefault(name, {"calls": 0, "designs": {}, "flops": 0,
                                    "bytes": 0})
    w["calls"] += 1
    if design is not None:
        w["designs"][design] = w["designs"].get(design, 0) + 1
    w["flops"] += int(flops)
    w["bytes"] += read + sum(t.numel() * t.element_size()
                             for t in (*inputs, *outputs))


def fake_calls() -> dict:
    """``FAKE_WORK``'s calls as the launch counts name them: by kernel
    (``"gmm"``) and by design (``"gmm:wgmma"``)."""
    return {"by_kernel": {k: w["calls"] for k, w in FAKE_WORK.items()},
            "by_design": {f"{k}:{d}": n for k, w in FAKE_WORK.items()
                          for d, n in w["designs"].items()}}


def reset_fake_work() -> None:
    FAKE_WORK.clear()


def on_cpu(*tensors) -> bool:
    """Route of a kernel wrapper: True when every tensor lies on the CPU
    (the plain version runs), False when all lie on one CUDA device (the
    kernel runs). Raises for anything else: mixed devices, or a device
    with no kernel."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def sass_counts(opcode: str) -> dict:
    """Lines of each built library's SASS (``cuobjdump -sass``) that hold
    ``opcode`` (e.g. ``"HGMMA"``, the tensor-core wgmma), by source stem."""
    tool = pathlib.Path(_nvcc()).with_name("cuobjdump")
    counts = {}
    for lib in sorted(build_dir().glob("lib*.so")):
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts[lib.stem[3:]] = sum(opcode in ln for ln in sass.splitlines())
    return counts


def build_logs() -> dict:
    """nvcc's ``-Xptxas=-v`` report (registers, shared memory, spills) of
    each source's last build, by source stem."""
    d = build_dir()
    return {p.stem: p.read_text() for p in sorted(d.glob("*.log"))}
