"""Every cell of BENCHMARK.json resolves by name to its files, and every
configuration is the tree the port builds."""

import json
import math

import pytest

from perfbench import check, spec
from perfbench.model import MoESpec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.find_cell(name)
    assert cell.chips in (1, 4)
    spec.load_driver(cell.traffic["kind"])
    for m in cell.per_layer:
        assert callable(spec.load_reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert set(cell.limits) == set(check.NUMBERS)
    assert all(0 < v < math.inf for v in cell.limits.values())


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_ports_tree(c):
    from repro_torch.models import stack
    from perfbench.drivers.train import model_config
    conf = json.loads((spec.ROOT / c["file"]).read_text())
    assert conf["name"] == c["name"]
    assert sorted(conf["reduced"]) == sorted(c["reduced"])
    m = MoESpec.from_config(conf)
    port = {k: tuple(s.shape) for k, s in
            stack.flat_param_specs(model_config(m)).items()}
    assert port == {k: tuple(s) for k, (s, _) in m.layout().items()}
    assert m.n_params() == sum(math.prod(s) for s in port.values())


def test_w1_is_the_registry_arch():
    import dataclasses
    from repro_torch.models import registry
    from perfbench.drivers.train import model_config
    m = MoESpec.from_config(spec.find_cell("w1.zebra.4k").config)
    assert dataclasses.replace(model_config(m), name="mixtral-w1") == \
        registry.get_config("mixtral-w1")


def test_metric_entries_name_their_cells():
    cells = set(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
