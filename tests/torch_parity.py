"""Shared helpers of the ``test_torch_*`` parity tests (not a test module).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs as its own tests run it on the CPU (Pallas kernels in
interpret mode, ``Policy(compute_dtype=float32)``), the port runs the
plain versions of its kernels (CPU tensors).
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_single_thread():
    """One intra-op thread: the test workers share the host's cores, and
    torch's default thread pool oversubscribes them by ~50x."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def to_np(x):
    """jax array / torch tensor -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_values_np(tree):
    """A JAX value tree (nested dicts) -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: jax_values_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def split3(x):
    """The tensor-core kernels' split of f32 x (csrc/sm90.cuh split3):
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded
    to nearest even; hi + mid + lo == x for 2^-110 <= |x| <
    (2 - 2^-8) 2^127 (tests/test_torch_gmm_dw.py holds it)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)
