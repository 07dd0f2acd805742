"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds, not minutes. All sources compile in parallel (one ``nvcc``
each, all started together). Libraries land in
``<repo>/build/repro_torch_kernels/<hash>/``, keyed by a hash of the
sources and flags, so an edited kernel rebuilds and an unchanged one is
reused. Nothing is built at import: the first kernel launch builds.
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
