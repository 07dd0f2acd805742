"""The port's dry run from its command line at full width, and its
collective tally against ``launch/mesh_comm.py``'s count of the same step
on gloo ranks (the one counter both tools share)."""

import json
import os
import pathlib
import subprocess
import sys

from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.models.config import ShapeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    return env


def test_cli_full_width_cell():
    """llama3.2-3b decode_32k at 16x16 (the registry's full config: 28
    layers, d 3072; 128 rows over 16 data ranks, a 32768-line cache split
    over 16 model ranks): one ok record, exit 0."""
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-3b", "--shape", "decode_32k"],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    recs = [json.loads(ln) for ln in p.stdout.splitlines()
            if ln.startswith("{")]
    assert len(recs) == 1
    r = recs[0]
    assert (r["arch"], r["shape"], r["mesh"], r["status"], r["n_devices"]) \
        == ("llama3.2-3b", "decode_32k", "16x16", "ok", 256)
    assert r["fits_80gb"] and 0 < r["total_bytes_per_device"] < 80e9
    assert r["flops_per_device"] > 0 and r["hbm_bytes_per_device"] > 0
    assert r["peak_flops"] == 989e12 and r["link_bw"] == 50e9
    assert r["bound"] in ("compute", "memory", "collective")
    assert "[dryrun] ok=1 skipped=0 failed=0" in p.stderr


def test_collective_tally_matches_mesh_comm(tmp_path):
    """Smoke mixtral-d2 at 1x2, batch 8 x seq 32, the train driver's zebra
    default (replicated, 2 microbatches): the dry run's calls by kind and
    ring bytes equal what ``mesh_comm`` counts on two gloo ranks for the
    same step."""
    out = tmp_path / "comm.json"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mesh_comm", "--arch",
         "mixtral-d2", "--smoke", "--device", "cpu", "--mesh", "1x2",
         "--batch", "8", "--seq", "32", "--steps", "1", "--out", str(out)],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    gloo = json.loads(out.read_text())["rank0"]
    rec = dryrun.lower_cell("mixtral-d2", ShapeConfig("cli", "train", 32, 8),
                            multi_pod=False, mesh_shape=(1, 2),
                            cfg=registry.smoke_config(
                                registry.get_config("mixtral-d2")),
                            zebra_mode="replicated", microbatches=2)
    assert rec["collective_calls"] == {k: c["calls"]
                                       for k, c in gloo.items()}
    assert rec["ring_collective_bytes_per_device"] == sum(
        c["ring_bytes"] for c in gloo.values()) > 0
    assert rec["collective_bytes_per_device"] == sum(
        c["operand_bytes"] for c in gloo.values())
