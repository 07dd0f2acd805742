"""The port's dry-run inputs (``repro_torch/configs/inputs.py``) against the
JAX package's (``repro/configs/inputs.py``): ``input_specs`` gives the same
names, shapes and dtypes for every arch of the registry at every shape;
``make_batch`` the same structure, its values drawn from an explicit
generator (the JAX version folds the per-process ``hash(name)`` into its
key, so its values cannot be held)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registers the JAX configs)
from repro.configs.inputs import input_specs as j_input_specs
from repro.configs.inputs import make_batch as j_make_batch
from repro.models import registry as j_registry
from repro.models.config import SHAPES as J_SHAPES
from repro_torch.configs import input_specs, make_batch
from repro_torch.models import registry, stack
from repro_torch.models.config import SHAPES

DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}
ARCHS = registry.names()


def as_torch(specs: dict) -> dict:
    """JAX specs as {name: (shape, torch dtype)}."""
    return {k: (tuple(s.shape), DTYPES[jnp.dtype(s.dtype)])
            for k, s in specs.items()}


def test_registries_and_shapes_agree():
    assert ARCHS == j_registry.names() and len(ARCHS) == 15
    assert list(SHAPES) == list(J_SHAPES)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch, shape):
    got = {k: (s.shape, s.dtype)
           for k, s in input_specs(registry.get_config(arch), shape).items()}
    assert got == as_torch(j_input_specs(j_registry.get_config(arch), shape))


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_input_specs_f32_fronts_match_jax(arch):
    got = {k: (s.shape, s.dtype) for k, s in input_specs(
        registry.get_config(arch), "prefill_32k", torch.float32).items()}
    want = as_torch(j_input_specs(j_registry.get_config(arch),
                                  "prefill_32k", jnp.float32))
    assert got == want and any(d == torch.float32 for _, d in got.values())


def smoke(reg, arch):
    return reg.smoke_config(reg.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_structure_matches_jax(arch):
    cfg = smoke(registry, arch)
    got = make_batch(torch.Generator().manual_seed(0), cfg, "train_4k")
    want = j_make_batch(jax.random.PRNGKey(0), smoke(j_registry, arch),
                        "train_4k")
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape
        assert got[k].dtype == DTYPES[jnp.dtype(v.dtype)]
    for k in ("tokens", "targets"):
        t = got[k]
        assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size


def test_make_batch_is_a_function_of_the_generator():
    cfg = smoke(registry, "whisper-tiny")
    a = make_batch(torch.Generator().manual_seed(7), cfg, "decode_32k")
    b = make_batch(torch.Generator().manual_seed(7), cfg, "decode_32k")
    c = make_batch(torch.Generator().manual_seed(8), cfg, "decode_32k")
    assert list(a) == ["tokens", "encoder_embeds"]
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["encoder_embeds"], c["encoder_embeds"])


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b",
                                  "mixtral-w1"])
def test_zero_fronts_follow_input_specs(arch):
    """The drivers' zero fronts are the specs' fronts at their batch."""
    cfg = smoke(registry, arch)
    fronts = stack.zero_fronts(cfg, 3, torch.bfloat16)
    specs = input_specs(cfg, "train_4k")
    assert {k: (tuple(v.shape[1:]), v.dtype) for k, v in fronts.items()} \
        == {k: (s.shape[1:], s.dtype) for k, s in specs.items()
            if k not in ("tokens", "targets")}
    assert all(v.shape[0] == 3 and not v.any() for v in fronts.values())
    assert np.prod(specs["tokens"].shape) == 256 * 4096
