"""The check has to fail what it is there to catch. A whole run of the
harness on the CPU (its look for a chip skipped, a small size): sound with
the port's products in f32, ``correct`` is true under the cell's limits;
with the timed path broken underneath (a step that leaves its state
unchanged; a step over half the batch) it is false; and the control, the
reference with e4m3 products in the program's place, fails them too."""

import functools
import json

import pytest
import torch

from perfbench import check, harness, spec
from perfbench import reference as ref
from perfbench.drivers import train as D
from perfbench.faults import FAULTS
from tiny import tiny_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture
def f32_port(monkeypatch):
    import repro_torch.models.modules as modules
    monkeypatch.setattr(modules, "Policy", functools.partial(
        modules.Policy, compute_dtype=torch.float32))
    torch.set_num_threads(1)


def _run(cell, fault, capsys, seed=7):
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0.5", "--trace", "0"], 0.0,
                      require_chip=False, device="cpu", fault=fault,
                      cell=tiny_cell(cell))
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line["checks"]) == list(check.NUMBERS)
    assert err.strip().splitlines()[-1].startswith("[perfbench] correct=")
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(f32_port, cell, capsys):
    line = _run(cell, None, capsys)
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "train_tokens_per_s", "mfu"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(f32_port, cell, fault, capsys):
    assert _run(cell, FAULTS[fault], capsys)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    torch.set_num_threads(1)
    c = tiny_cell(cell)
    s = D.setup(c, 7, "cpu")
    base = D.reference_readings(s)
    ok, _ = check.verdict(D.reference_readings(s, ref.FP8), base, c.limits)
    assert not ok
