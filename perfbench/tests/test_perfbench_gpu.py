"""On the card (``gpu`` marker; skips without a CUDA device): one cell at
its own size, one seed, the program's readings within the cell's limits
and the control's outside them.

    python -m pytest -m gpu perfbench/tests/test_perfbench_gpu.py
"""

import pytest
import torch

from perfbench import calibrate, spec


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["w1.dropless.4k"])
def test_cell_passes_and_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    limits = spec.find_cell(cell).limits
    recs = calibrate.main(["--workload", cell, "--seeds", "901",
                           "--control", "901"])
    by = {r["kind"]: r for r in recs}
    assert all(by["sound"][k]["value"] <= v for k, v in limits.items())
    control = by["control fp8_e4m3"]
    assert any(control[k]["value"] > v for k, v in limits.items())
