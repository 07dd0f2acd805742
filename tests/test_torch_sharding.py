"""repro_torch's sharding rules (``sharding/rules.py``) against the JAX
package's, leaf by leaf, with no process spawned.

For every arch of ``test_torch_config.PORTED`` at its full size: the
logical axes of every param (``stack.param_axes``) equal the JAX
package's ``abstract_params(cfg)[1]``; and on each mesh shape (1x1, 1x2,
2x1, 2x2, 2x4 and 2x2x2 with "pod", over conftest's 8 CPU devices) and
each variant (default, tp, ep, hybrid, serve): ``rules_for`` gives the
same rules, ``fitted_specs`` the same spec as ``tuple(spec)`` of the JAX
package's ``fitted_shardings`` for every param and every optimizer-state
leaf (``opt_state_axes`` under the ZeRO-1 rules), and ``local_shape``
the same block shape as ``NamedSharding.shard_shape``. The ZeRO-1 rule
itself (a fully replicated leaf's moments split over "data") is held on
synthetic axes, since no arch of the registry has such a leaf.
"""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import registry as jregistry
from repro.pytree import axes_map
from repro.sharding import rules as jrules
from repro.train import optimizer as jopt
from repro.train.step import _zero1_rules as jzero1_rules
from repro.train.step import abstract_params
from repro_torch.models import registry, stack
from repro_torch.sharding import rules
from repro_torch.train import optimizer as opt
from repro_torch.train.step import _zero1_rules
from test_torch_config import PORTED

MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
VARIANTS = ("default", "tp", "ep", "hybrid", "serve")
_CACHE = {}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        n = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, n))
        else:
            out[n] = v
    return out


def jax_params(arch):
    """(shapes {path: shape}, axes tree) of the JAX package's params."""
    if arch not in _CACHE:
        vals, axes = abstract_params(jregistry.get_config(arch))
        _CACHE[arch] = ({k: tuple(v.shape) for k, v in _flat(vals).items()},
                        vals, axes)
    return _CACHE[arch]


def _jax_specs(shapes_tree, axes_tree, rules_, mesh):
    sh = jrules.fitted_shardings(shapes_tree, axes_tree, rules_, mesh)
    return {k: tuple(v.spec) for k, v in _flat(sh).items()}


@pytest.mark.parametrize("arch", PORTED)
def test_param_axes_match_jax(arch):
    _, _, jaxes = jax_params(arch)
    got = stack.param_axes(registry.get_config(arch))
    assert got == {k: tuple(v) for k, v in _flat(
        axes_map(tuple, jaxes)).items()}


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
@pytest.mark.parametrize("arch", PORTED)
def test_fitted_specs_match_jax(arch, shape, axes):
    jmesh = jmake_mesh(shape, axes)
    mesh = rules.MeshShape(shape, axes)
    shapes, jvals, jaxes = jax_params(arch)
    cfg = registry.get_config(arch)
    paxes = stack.param_axes(cfg)
    for variant in VARIANTS:
        jr = jrules.rules_for(jregistry.get_config(arch), jmesh, variant)
        r = rules.rules_for(cfg, mesh, variant)
        assert (dict(r.rules), dict(r.act_rules), r.batch_axes) == \
            (dict(jr.rules), dict(jr.act_rules), jr.batch_axes), variant
        specs = rules.fitted_specs(shapes, paxes, r, mesh)
        assert specs == _jax_specs(jvals, jaxes, jr, jmesh), variant
        for k, s in specs.items():
            want = NamedSharding(jmesh, jax.sharding.PartitionSpec(*s)) \
                .shard_shape(shapes[k])
            assert rules.local_shape(s, shapes[k], mesh) == tuple(want), k
        for master in (False, True):
            o = opt.opt_state_axes(paxes, master_weights=master)
            jo = jopt.opt_state_axes(jaxes, master_weights=master)
            zr, jzr = _zero1_rules(r), jzero1_rules(jr)
            for key in o:
                if key == "step":
                    assert o[key] == tuple(jo[key]) == ()
                    continue
                got = rules.fitted_specs(shapes, o[key], zr, mesh)
                assert got == _jax_specs(jvals, jo[key], jzr, jmesh), \
                    (variant, key)


ZERO_AXES = {"a": (None, None), "b": (None,), "c": ("embed", None),
             "d": (), "e": (None, "mlp")}
ZERO_SHAPES = {"a": (8, 6), "b": (6,), "c": (8, 4), "d": (), "e": (3, 8)}


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
def test_zero1_moment_specs_match_jax(shape, axes):
    """A fully replicated leaf's moments take "data" on their first dim
    where it divides; the others keep the param's spec."""
    jmesh, mesh = jmake_mesh(shape, axes), rules.MeshShape(shape, axes)
    cfg = registry.get_config("llama3.2-3b")
    r = _zero1_rules(rules.rules_for(cfg, mesh))
    jr = jzero1_rules(jrules.rules_for(jregistry.get_config("llama3.2-3b"),
                                       jmesh))
    o = opt.opt_state_axes(ZERO_AXES, master_weights=True)
    jo = jopt.opt_state_axes(ZERO_AXES, master_weights=True)
    vals = {k: jax.ShapeDtypeStruct(s, np.float32)
            for k, s in ZERO_SHAPES.items()}
    for key in ("mu", "nu", "master"):
        assert o[key] == {k: tuple(v) for k, v in jo[key].items()}
        assert rules.fitted_specs(ZERO_SHAPES, o[key], r, mesh) == \
            _jax_specs(vals, jo[key], jr, jmesh)
    assert rules.fitted_specs(ZERO_SHAPES, o["mu"], r, mesh)["a"] == \
        ("data", None)


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
def test_local_slice_and_placements_follow_jax_block_order(shape, axes):
    """Rank r's block (``local_slice``) is the shard JAX puts on the r-th
    device of the mesh; ``placements`` shards each tensor dim on its mesh
    axes, data outermost."""
    from torch.distributed.tensor import Replicate, Shard

    jmesh, mesh = jmake_mesh(shape, axes), rules.MeshShape(shape, axes)
    full = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    for spec in [(None, None), ("data", None), (None, "model"),
                 ("model", "data"), (("data", "model"), None),
                 (tuple(a for a in axes if a != "model"), "model")]:
        spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                     (e or None) for e in spec)
        arr = jax.device_put(full, NamedSharding(
            jmesh, jax.sharding.PartitionSpec(*spec)))
        by_dev = {s.device.id: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for r, dev in enumerate(jmesh.devices.flat):
            np.testing.assert_array_equal(
                rules.local_slice(spec, mesh, r, full), by_dev[dev.id])
        pl = rules.placements(spec, mesh)
        for a, p in zip(axes, pl):
            dims = [d for d, e in enumerate(spec)
                    if a in rules.entry_axes(e)]
            assert p == (Shard(dims[0]) if dims else Replicate())


def test_zero1_update_matches_the_unsharded_update():
    """``adamw_update(zero1=)``: a rank updates its block of a ZeRO-1
    leaf (gradient, param and moments cut by ``take``) and rebuilds the
    param with ``gather``; with the other block taken from the unsharded
    update, param and moment block equal the unsharded update's bits."""
    import torch

    gen = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(8, 6, generator=gen),
         "b": torch.randn(6, generator=gen)}
    g = {k: torch.randn(v.shape, generator=gen) for k, v in p.items()}
    cfg = opt.OptimizerConfig(peak_lr=1e-2, warmup_steps=1)
    ref_p = {k: v.clone() for k, v in p.items()}
    ref_s = opt.init_opt_state(ref_p)
    ref_s["mu"]["a"].fill_(0.1)
    ref_s["nu"]["a"].fill_(0.2)
    zp = {k: v.clone() for k, v in p.items()}
    zs = opt.init_opt_state(zp)
    zs["mu"]["a"] = torch.full((4, 6), 0.1)
    zs["nu"]["a"] = torch.full((4, 6), 0.2)
    opt.adamw_update(cfg, ref_p, {k: v.clone() for k, v in g.items()},
                     ref_s)
    zero1 = {"a": (lambda t: t[4:],
                   lambda blk: torch.cat([ref_p["a"][:4], blk]))}
    _, _, m = opt.adamw_update(cfg, zp, {k: v.clone() for k, v in g.items()},
                               zs, zero1=zero1)
    assert torch.equal(zp["a"], ref_p["a"]) and torch.equal(zp["b"],
                                                             ref_p["b"])
    assert torch.equal(zs["mu"]["a"], ref_s["mu"]["a"][4:])
    assert torch.equal(zs["nu"]["a"], ref_s["nu"]["a"][4:])
