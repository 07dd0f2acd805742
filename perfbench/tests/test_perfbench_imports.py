"""Nothing the benchmark runs imports JAX, the JAX package or its
benchmarks: by top-level module name, compared whole (``repro_torch``
begins with ``repro`` and is the program)."""

import ast
import subprocess
import sys

from perfbench import harness, spec


def _imported(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_names_a_forbidden_module():
    for path in spec.HERE.rglob("*.py"):
        if "tests" in path.relative_to(spec.HERE).parts:
            continue
        assert not _imported(path) & set(harness.FORBIDDEN), path


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench import harness, spec, calibrate\n"
        "from perfbench.drivers import train\n"
        "import repro_torch.launch.train, repro_torch.core.zebra_spmd\n"
        "import repro_torch.train.optimizer\n"
        "for m in spec.load_benchmark()['per_layer']:\n"
        "    spec.load_reader(m['name'])\n"
        "print(harness.forbidden_modules())\n"
        % (str(spec.ROOT), str(spec.ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro" not in harness.forbidden_modules() or \
        "repro" in {n.split(".")[0] for n in sys.modules}
