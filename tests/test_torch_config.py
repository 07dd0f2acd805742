"""repro_torch configs, registry, init and the JAX weight bridge.

Every registered config is field-equal to the JAX registry's (and so is
its smoke reduction); the port's parameter count, computed from its own
init shapes, equals the JAX ``eval_shape`` count; a JAX ``split_params``
tree crosses ``params_from_jax`` with its paths, stacked layouts and values
intact.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.pytree import split_params
from repro_torch.models import registry, stack
from repro_torch.pytree import flatten, params_from_jax
from torch_parity import jax_values_np
from torch_parity import torch_single_thread  # noqa: F401 (fixture)

NAMES = sorted(jreg.names())
# The archs whose init the port has: every registered one (attention,
# RG-LRU and SSD mixers, cross-attention, whisper's encoder).
PORTED = ["dbrx-132b", "llama-3.2-vision-90b", "llama3.2-3b", "mamba2-2.7b",
          "mixtral-d1", "mixtral-d2", "mixtral-d3", "mixtral-w1",
          "mixtral-w2", "qwen3-32b", "qwen3-moe-30b-a3b",
          "recurrentgemma-9b", "starcoder2-15b", "whisper-tiny", "yi-34b"]


def test_registry_names_match():
    assert registry.names() == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_config_field_equal(name):
    want = jreg.get_config(name)
    got = registry.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(registry.smoke_config(got)) \
        == dataclasses.asdict(jreg.smoke_config(want))
    assert got.param_count() == want.param_count()


@pytest.mark.parametrize("name", PORTED)
def test_exact_param_count_matches_jax(name):
    cfg = registry.get_config(name)
    jcfg = jreg.get_config(name)
    assert registry.exact_param_count(cfg) == jreg.exact_param_count(jcfg)
    assert registry.exact_param_count(registry.smoke_config(cfg)) \
        == jreg.exact_param_count(jreg.smoke_config(jcfg))


def test_unported_layer_kinds_raise():
    """No layer kind is refused any more. The cross-attention archs'
    ``param_specs`` (whisper's encoder, learned positions, the vision
    projection, a layer without a mixer) equal JAX's ``split_params`` tree
    key by key and shape by shape, at full size (``jax.eval_shape``, no
    allocation) and at smoke size. The recurrent archs build their decode
    states in both layouts: a per-slot recurrent state per RG-LRU or SSD
    layer."""
    for name in ("whisper-tiny", "llama-3.2-vision-90b"):
        for cfg, jcfg in ((registry.get_config(name), jreg.get_config(name)),
                          (registry.smoke_config(registry.get_config(name)),
                           jreg.smoke_config(jreg.get_config(name)))):
            want = flatten(jax.eval_shape(lambda c=jcfg: split_params(
                jstack.init_model(jax.random.PRNGKey(0), c))[0]))
            got = stack.flat_param_specs(cfg)
            assert sorted(got) == sorted(want), name
            for k, spec in got.items():
                assert tuple(spec.shape) == tuple(want[k].shape), (name, k)
    for name, kind in (("mamba2-2.7b", "ssd"), ("recurrentgemma-9b",
                                                "rglru")):
        cfg = registry.smoke_config(registry.get_config(name))
        for st in (stack.init_decode_state(cfg, 3, 8, torch.float32),
                   stack.init_paged_decode_state(cfg, 3, 4, 8,
                                                 torch.float32)):
            rec = st["blocks"]["pos0"][kind]
            assert rec["conv"].shape[:2] == (cfg.n_pattern_repeats, 3)


def test_params_from_jax_keeps_paths_layout_and_values():
    jcfg = jreg.smoke_config(jreg.get_config("mixtral-w2"))
    cfg = registry.smoke_config(registry.get_config("mixtral-w2"))
    values = jax_values_np(
        split_params(jstack.init_model(jax.random.PRNGKey(3), jcfg))[0])
    params = params_from_jax(values)
    flat_p, flat_v = flatten(params), flatten(values)
    specs = stack.flat_param_specs(cfg)
    assert sorted(flat_p) == sorted(flat_v) == sorted(specs)
    for name, t in flat_p.items():
        assert tuple(t.shape) == tuple(specs[name].shape), name
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), flat_v[name])
    # stacked blocks keep the leading layer axis
    assert params["blocks"]["pos0"]["mixer"]["wq"].shape[0] == cfg.n_layers


def test_init_model_is_seeded_and_fan_in_scaled():
    cfg = registry.smoke_config(registry.get_config("mixtral-w2"))

    def init(seed):
        g = torch.Generator().manual_seed(seed)
        return flatten(stack.init_model(g, cfg))

    a, b, c = init(0), init(0), init(1)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    wg = a["blocks/pos0/ffn/wi_gate"]
    assert not torch.equal(wg, c["blocks/pos0/ffn/wi_gate"])
    std = 1.0 / math.sqrt(cfg.d_model)
    # 2-sigma truncation, variance-corrected: |w| <= 2 * std / 0.8796
    assert float(wg.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(wg.std()) / std - 1.0) < 0.02
    assert torch.equal(a["final_norm/scale"], torch.ones(cfg.d_model))
