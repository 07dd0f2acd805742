"""repro_torch's serving mesh, the rest of it against the JAX package:

* the disaggregated deployment and the fleet (one kill, fixed straggler
  step times in both packages) at 1x2 on gloo ranks against the JAX
  deployments on a 1x2 mesh, held as in ``tests/test_torch_serve_mesh.py``
  (``torch_parity.check_serve_mesh``; the fleet records no logits);
* ``serve.mesh.decode_state_specs`` / ``paged_state_specs`` against the
  JAX package's, leaf by leaf, for every arch of the registry at 1x2,
  2x2 and 2x4, at slot counts, lengths and pool sizes that divide and
  that do not;
* the log-sum-exp output of ``paged_decode_plain`` against a direct f64
  reference, and the two-half merge of a pool (each half through a
  rank-local table) against the whole pool's output;
* the driver's refusals by name, before any device work: the prefix
  cache of a recurrent arch on a mesh (the JAX message), a CUDA mesh
  larger than the cards present, an ``--ep-size`` other than the "model"
  axis (the JAX message), a config that repeats its layer pattern once;
  and the recurrent, encoder-decoder and vision archs, refused on a mesh
  until the port served them, served on one (exit 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import registry as jreg
from repro.pytree import tree_map_with_path_names
from repro.serve import config as jconfig
from repro.serve import engine as jengine
from repro.sharding.rules import rules_for as jrules_for
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import serve as serve_mod
from repro_torch.models import registry
from repro_torch.models.modules import merge_attention, merge_partials
from repro_torch.serve import mesh as serve_mesh
from repro_torch.sharding.rules import MeshShape, rules_for
from torch_parity import check_serve_mesh, run_serve_mesh, serve_trace
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

MOE, DENSE = "qwen3-moe-30b-a3b", "llama3.2-3b"
BASE = {"slots": 4, "max_len": 28, "prefill_chunk": 8}
CASES = [
    {"name": "disagg_prefix", "arch": MOE, "mesh": [1, 2],
     "sc": dict(BASE, disagg={"enabled": True},
                paged={"page_size": 4, "pool_pages": 10},
                prefix={"enabled": True}),
     "trace": serve_trace(MOE, 6, seed=5, tenants=2)},
    {"name": "fleet_kill", "arch": DENSE, "mesh": [1, 2],
     "sc": dict(BASE, paged={"page_size": 4},
                fleet={"enabled": True, "prefill_groups": ["a40", "a40"],
                       "decode_groups": ["v100", "v100"],
                       "kills": [[6, 2]]}),
     "trace": serve_trace(DENSE, 6, seed=5)},
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_serve_mesh(tmp_path_factory.mktemp("serve_modes"),
                          jmake_mesh((1, 2), ("data", "model")), 2, CASES)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_serve_mesh_modes_match_jax(runs, case):
    ref, ranks = runs
    check_serve_mesh(case, ref[case["name"]], ranks[case["name"]])


# ---------------------------------------------------------------------------
# Decode-state specs
# ---------------------------------------------------------------------------

def _jax_specs(tree):
    from jax.sharding import PartitionSpec
    out = {}
    tree_map_with_path_names(lambda n, s: out.__setitem__(n, tuple(s)),
                             tree, is_leaf=lambda x: isinstance(x,
                                                                PartitionSpec))
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)])
@pytest.mark.parametrize("geom", [(4, 64, 12), (3, 63, 9)])
def test_state_specs_equal_jax(shape, geom):
    """Every leaf's spec of the dense and paged decode states, for all
    archs of the registry (full configs), equals the JAX package's."""
    import jax.numpy as jnp
    batch, max_len, n_pages = geom
    jmesh = jmake_mesh(shape, ("data", "model"))
    mesh = MeshShape(shape, ("data", "model"))
    assert sorted(registry.names()) == sorted(jreg.names())
    assert len(registry.names()) == 15
    for arch in registry.names():
        jcfg, cfg = jreg.get_config(arch), registry.get_config(arch)
        jr, r = jrules_for(jcfg, jmesh, "serve"), rules_for(cfg, mesh,
                                                            "serve")
        _, want = jengine.decode_state_specs(jcfg, jmesh, jr, batch,
                                             max_len, jnp.bfloat16)
        got = serve_mesh.decode_state_specs(cfg, mesh, r, batch, max_len)
        assert got == _jax_specs(want), (arch, shape, geom)
        _, want = jengine.paged_state_specs(jcfg, jmesh, jr, batch,
                                            n_pages, 16, jnp.bfloat16)
        got = serve_mesh.paged_state_specs(cfg, mesh, r, batch, n_pages, 16)
        assert got == _jax_specs(want), (arch, shape, geom)


# ---------------------------------------------------------------------------
# The paged decode's log-sum-exp and the two-half merge
# ---------------------------------------------------------------------------

def _pool_case(seed, softcap=0.0, window=0):
    g = torch.Generator().manual_seed(seed)
    B, KH, G, hd, ps, P, MP = 4, 2, 3, 32, 4, 12, 5
    q = torch.randn((B, KH, G, hd), generator=g)
    kp = torch.randn((P, ps, KH, hd), generator=g)
    vp = torch.randn((P, ps, KH, hd), generator=g)
    table = torch.full((B, MP), -1, dtype=torch.int32)
    table[0, :3] = torch.tensor([7, 1, 10])     # both halves
    table[1, :2] = torch.tensor([2, 4])         # the first half only
    table[2, :5] = torch.tensor([11, 6, 9, 0, 3])
    table[3, :1] = torch.tensor([8])            # dead slot
    q_pos = torch.tensor([10, 6, 18, -1], dtype=torch.int32)
    return dict(q=q, k_pool=kp, v_pool=vp, page_table=table, q_pos=q_pos,
                scale=hd ** -0.5, softcap=softcap, window=window)


def _direct_lse(c):
    """log sum exp of each row's scaled (soft-capped) scores over its live
    lines, in f64, from the table and the structural positions."""
    q, kp = c["q"].double(), c["k_pool"].double()
    B, KH, G, hd = q.shape
    ps = kp.shape[1]
    out = torch.full((B, KH, G), -torch.inf, dtype=torch.float64)
    for b in range(B):
        p = int(c["q_pos"][b])
        scores = []
        for j, page in enumerate(c["page_table"][b].tolist()):
            for line in range(ps):
                pos = j * ps + line
                if page < 0 or p < 0 or pos > p or (
                        c["window"] and p - pos >= c["window"]):
                    continue
                s = torch.einsum("kgh,kh->kg", q[b], kp[page, line]) \
                    * c["scale"]
                if c["softcap"]:
                    s = c["softcap"] * torch.tanh(s / c["softcap"])
                scores.append(s)
        if scores:
            out[b] = torch.logsumexp(torch.stack(scores), 0)
    return out


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (5.0, 0), (0.0, 6)])
def test_paged_plain_lse_and_two_half_merge(softcap, window):
    c = _pool_case(3, softcap, window)
    out, lse = pa.paged_decode_plain(**c, return_lse=True)
    assert torch.equal(out, pa.paged_decode_plain(**c))
    want = _direct_lse(c)
    live = torch.isfinite(want)
    assert torch.equal(torch.isfinite(lse), live)
    assert float((lse.double() - want)[live].abs().max()) < 1e-5
    assert bool((out[3] == 0).all())                     # dead slot
    P, half = c["k_pool"].shape[0], c["k_pool"].shape[0] // 2
    parts = []
    for lo in (0, half):
        t = c["page_table"]
        own = (t >= lo) & (t < lo + half)
        parts.append(pa.paged_decode_plain(**dict(
            c, k_pool=c["k_pool"][lo:lo + half],
            v_pool=c["v_pool"][lo:lo + half],
            page_table=torch.where(own, t - lo, -1).to(torch.int32)),
            return_lse=True))
    assert not torch.isfinite(parts[1][1][1]).any()      # no live line
    merged = merge_partials(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]))
    assert float((merged - out).abs().max()) <= 1e-6 * float(
        out.abs().max())
    # the model code's merge over one rank is the identity on its partial
    assert torch.equal(merge_attention(out, lse, None), out)


# ---------------------------------------------------------------------------
# Refusals by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,why", [
    (["--arch", "recurrentgemma-9b", "--mesh", "1x2", "--paged",
      "--prefix-cache"], "--prefix-cache needs per-position KV only"),
    (["--arch", "mamba2-2.7b", "--mesh", "2x1", "--paged",
      "--prefix-cache"], "--prefix-cache needs per-position KV only"),
    (["--arch", "llama3.2-3b", "--mesh", "1x2", "--device", "cuda"],
     "needs 2 CUDA devices"),
    (["--arch", "llama3.2-3b", "--mesh", "2"], "expected DxM"),
])
def test_driver_refuses_by_name(capsys, argv, why):
    if "--device" not in argv:
        argv = argv + ["--device", "cpu"]
    if why.startswith("needs") and torch.cuda.device_count() >= 2:
        pytest.skip("this host has the cards")
    assert serve_mod.main(["--smoke"] + argv) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith(
        "[serve] invalid configuration:") and why in err[0], err


@pytest.mark.parametrize("argv", [
    ["--arch", "recurrentgemma-9b", "--mesh", "1x2"],
    ["--arch", "mamba2-2.7b", "--mesh", "2x1", "--paged"],
    ["--arch", "mamba2-2.7b", "--mesh", "1x2", "--paged"],
    ["--arch", "whisper-tiny", "--mesh", "1x2", "--paged"],
    ["--arch", "llama-3.2-vision-90b", "--mesh", "2x2"],
])
def test_driver_serves_on_a_mesh(capfd, argv):
    """The command lines refused by name until the recurrent states and
    the lockstep server were ported to the mesh now serve, exit 0."""
    cfg = registry.get_config(argv[1])
    assert serve_mesh.unported_on_mesh(cfg) is None
    assert serve_mod.main(["--smoke", "--device", "cpu", "--requests", "3",
                           "--gen", "8", *argv]) == 0
    out = capfd.readouterr().out  # rank 0, a spawned process
    assert f"[serve] arch={argv[1]}-smoke" in out


def test_single_pattern_repeat_refused_on_a_mesh():
    """A config whose layer pattern runs once: its cache leaves carry a
    leading 1, which the JAX specs do not count as stacked, so they split
    the slots over "model"; the port splits lines and refuses it."""
    cfg = registry.smoke_config(registry.get_config("llama3.2-3b"))
    spec = type(cfg.pattern[0])
    one = dataclasses.replace(cfg, pattern=(spec(mixer="local_attn"),
                                            spec()), window=8)
    assert one.n_pattern_repeats == 1
    assert serve_mesh.unported_on_mesh(cfg) is None
    assert "repeats its layer pattern once" in \
        serve_mesh.unported_on_mesh(one)


def test_ep_size_other_than_model_axis_refused_with_jax_message(capsys):
    """``--ep-size 4`` on a 1x2 mesh: the JAX validation's message."""
    jmesh = jmake_mesh((1, 2), ("data", "model"))
    jcfg = jreg.smoke_config(jreg.get_config(MOE))
    with pytest.raises(jconfig.ServeConfigError) as e:
        jconfig.ServeConfig(ep=jconfig.EPCfg(ep_size=4)).validate(
            model_cfg=jcfg, mesh=jmesh)
    assert serve_mod.main(["--smoke", "--arch", MOE, "--mesh", "1x2",
                           "--ep-size", "4", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert str(e.value) in err and "ep_size 4 != mesh axis 'model' size 2" \
        in err
