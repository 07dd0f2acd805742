"""The port stands alone: importing every ``repro_torch`` module leaves
``jax`` and the JAX package ``repro`` out of ``sys.modules``."""

import pathlib
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

SCRIPT = r"""
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1])
mods = sorted(".".join(p.relative_to(root).with_suffix("").parts)
              .replace(".__init__", "")
              for p in (root / "repro_torch").rglob("*.py"))
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
core = ("hardware", "schedule", "profiler", "asym_ea", "simulator",
        "planner", "zebra_mpmd", "zebra_spmd")
assert {"repro_torch.core." + m for m in core} <= set(mods), mods
assert "repro_torch.launch.hetero_mpmd" in mods, mods
infra = ("repro_torch.checkpoint", "repro_torch.checkpoint.manager",
         "repro_torch.obs", "repro_torch.obs.trace", "repro_torch.ft",
         "repro_torch.ft.elastic", "repro_torch.train.compression",
         "repro_torch.ft.chaos", "repro_torch.serve.prefix_index",
         "repro_torch.serve.kv_transfer", "repro_torch.serve.disagg",
         "repro_torch.serve.disagg.workers",
         "repro_torch.serve.disagg.controller", "repro_torch.serve.fleet",
         "repro_torch.serve.fleet.controller",
         "repro_torch.serve.fleet.router", "repro_torch.serve.fleet.sim",
         "repro_torch.serve.ep_decode", "repro_torch.sharding",
         "repro_torch.sharding.rules", "repro_torch.sharding.collectives",
         "repro_torch.launch.mesh")
assert set(infra) <= set(mods) and set(infra) <= set(sys.modules), mods
print(len(mods), bad)
assert not bad, bad
"""


def test_repro_torch_imports_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(SRC)],
                         env={"PYTHONPATH": str(SRC), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 25 and bad.strip() == "[]"


def test_core_package_imports_no_jax_and_no_repro():
    """The zebra engine (``repro_torch.core``) alone, with the modules it
    pulls in, leaves jax and the JAX package out."""
    script = ("import sys, repro_torch.core.zebra_spmd\n"
              "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'repro')]\n"
              "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", script],
                         env={"PYTHONPATH": str(SRC), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "core.hardware", "core.schedule", "core.profiler", "core.asym_ea",
    "core.simulator", "core.planner", "core.zebra_mpmd",
    "launch.hetero_mpmd", "checkpoint", "obs", "ft",
    "train.compression", "ft.chaos", "serve.prefix_index",
    "serve.kv_transfer", "serve.disagg", "serve.disagg.workers",
    "serve.disagg.controller", "serve.ep_decode"])
def test_planning_and_mpmd_modules_import_no_jax_and_no_repro(module):
    """Each planning copy, the MPMD engine and its entry point, each piece
    of training infrastructure (checkpointing, observability, fault
    tolerance, gradient compression) and each serving module of the prefix
    cache, the disaggregated deployment and expert-parallel decode alone, with the modules it
    pulls in, leave jax and the JAX package out."""
    script = (f"import sys, repro_torch.{module}\n"
              "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'repro')]\n"
              "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", script],
                         env={"PYTHONPATH": str(SRC), "PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_import_statement_names_jax_or_repro():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    files = list((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits
