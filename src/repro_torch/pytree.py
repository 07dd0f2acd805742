"""Parameter-tree utilities: initializer specs, seeded init, the JAX bridge.

Params are plain nested dicts of tensors with the same paths as the JAX
package's ``split_params`` value tree (``embed/table``,
``blocks/pos0/mixer/wq`` with a leading layer axis, ...). The ``init_*``
functions of :mod:`repro_torch.models.modules` return trees of
:class:`ParamSpec` (shape + initializer) instead of values, so the
parameter count (``registry.exact_param_count``) and the seeded init
(``stack.init_model``) read one shape table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf before materialization."""

    shape: tuple
    init: str = "fan_in"  # fan_in | ones | zeros | a_log | lam
    fan_in: int = 0       # fan_in init: stddev = 1 / sqrt(fan_in)

    def stacked(self, n: int) -> "ParamSpec":
        """The same leaf with a leading layer axis of size ``n``."""
        return dataclasses.replace(self, shape=(n,) + tuple(self.shape))


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten(tree, prefix: str = "") -> dict:
    """{'a/b/c': leaf} view of a dict tree (the JAX package's path
    names)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, name))
        else:
            out[name] = v
    return out


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

_TRUNC_STD = 0.87962566103423978  # stddev of N(0,1) truncated to [-2, 2]


def trunc_normal_init(shape, stddev: float, generator: torch.Generator,
                      device) -> torch.Tensor:
    """2-sigma truncated normal, variance-corrected like the JAX package's
    ``trunc_normal_init`` (pytree.py there): inverse-CDF sampling of a
    standard normal restricted to [-2, 2], scaled by stddev / 0.8796, in
    f32. Every step is in place, so peak memory is the output tensor."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(generator=generator)
    t.mul_(hi - lo).add_(lo).erfinv_().mul_(math.sqrt(2.0))
    return t.clamp_(-2.0, 2.0).mul_(stddev / _TRUNC_STD)


def fan_in_init(shape, fan_in: int, generator: torch.Generator,
                device) -> torch.Tensor:
    """LeCun-normal-style init: stddev = 1 / sqrt(fan_in)."""
    return trunc_normal_init(shape, 1.0 / math.sqrt(max(fan_in, 1)),
                             generator, device)


def a_log_init(shape, device) -> torch.Tensor:
    """mamba2's deterministic ``A_log`` = log(linspace(1, 16, nh)) over the
    last axis (A = -exp(A_log) spans [-16, -1]), broadcast over leading
    (stacked layer) axes. Computed in f64 and rounded once to f32: the
    correctly rounded values, which XLA's f32 ``linspace`` and ``log`` on
    the CPU match to within 2 ulp (and exactly at few heads)."""
    nh = shape[-1]
    row = torch.linspace(1.0, 16.0, nh, dtype=torch.float64).log()
    return row.to(torch.float32).expand(shape).contiguous().to(device)


def lam_init(shape, generator: torch.Generator, device) -> torch.Tensor:
    """The RG-LRU's Lambda (Griffin; the JAX package's ``init_rglru``):
    u ~ U(0.9, 0.999) drawn from ``generator``, then Lambda =
    log(u^(1/8) / (1 - u^(1/8))), so that a = sigmoid(Lambda)^8 lies in
    (0.9, 0.999). In f32, in place."""
    u = torch.empty(shape, dtype=torch.float32, device=device)
    r = u.uniform_(0.9, 0.999, generator=generator).pow_(1.0 / 8.0)
    return r.div_(1.0 - r).log_()


def materialize(specs, generator: torch.Generator, device):
    """Tree of ParamSpec -> tree of f32 tensors on ``device``, drawn in the
    tree's insertion order from ``generator``."""
    def one(spec: ParamSpec):
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=torch.float32, device=device)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=torch.float32, device=device)
        if spec.init == "a_log":
            return a_log_init(spec.shape, device)
        if spec.init == "lam":
            return lam_init(spec.shape, generator, device)
        return fan_in_init(spec.shape, spec.fan_in, generator, device)
    return tree_map(one, specs)


# ---------------------------------------------------------------------------
# The weight bridge
# ---------------------------------------------------------------------------

def _to_tensor(leaf: Any, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch twin
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_jax(values, device="cpu"):
    """The JAX package's ``split_params`` value tree (numpy arrays, or
    anything ``np.asarray`` takes) -> the port's parameter tree.

    Paths and layouts are kept as they are, including the stacked
    ``blocks/pos{i}/...`` leaves with their leading layer axis, so one set
    of weights feeds both packages."""
    return tree_map(lambda leaf: _to_tensor(leaf, device), values)
