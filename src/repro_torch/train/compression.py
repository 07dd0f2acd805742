"""Gradient compression with error feedback (mirror of
``repro/train/compression.py``).

For data parallelism over a slow link the gradient all-reduce is the
cost. Standard mitigation: quantize each rank's gradient contribution to
int8 with a per-tensor scale before the reduction and keep the
quantization residual in an error-feedback buffer (added back the next
step) so the compression bias vanishes over time (1-bit Adam / PowerSGD
lineage).

The arithmetic is the JAX package's, term by term, so both give the same
bits: per tensor amax + 1e-12 in f32, scale = amax / 127 (an f32 division),
q = clip(round_half_even(g / scale), -127, 127) as int8 (an element-wise
IEEE division by a 0-dim tensor on the tensor's own device: on the card a
CPU scalar divisor would be turned into a product with its reciprocal).
Trees are dicts of tensors (nested, or keyed by path names).

:func:`compressed_psum` is the reducer: it all-reduces the dequantized
contributions over a ``torch.distributed`` group, the JAX package's psum
over a ``shard_map`` axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.pytree import tree_map


def compress(g: torch.Tensor, *, bits: int = 8):
    """Per-tensor symmetric int quantization. Returns (q, scale): int8 q
    shaped like ``g``, a 0-dim f32 scale on ``g``'s device."""
    assert bits in (8,), "int8 is the supported wire format"
    amax = g.abs().amax() + 1e-12
    scale = amax / amax.new_tensor(127.0)
    q = torch.round(g / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def apply_error_feedback(g: torch.Tensor, err: torch.Tensor):
    """Add the residual of the previous step; returns (g_corrected, fn)
    where fn(decompressed) gives the new residual."""
    g_corr = g.to(torch.float32) + err

    def new_err(g_hat):
        return g_corr - g_hat

    return g_corr, new_err


def _tree_map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_map2(fn, v, b[k]) for k, v in a.items()}
    return fn(a, b)


def compress_tree(grads, err_state):
    """Compress a gradient tree with error feedback.

    Returns (q_tree, scale_tree, new_err_fn); new_err_fn must be called
    with the *decompressed* tree actually applied (the post-reduction
    mean) to compute the stored residual."""
    corrected = _tree_map2(lambda g, e: apply_error_feedback(g, e)[0],
                           grads, err_state)
    pairs = tree_map(compress, corrected)
    qs = tree_map(lambda p: p[0], pairs)
    scales = tree_map(lambda p: p[1], pairs)

    def new_err(applied):
        return _tree_map2(lambda c, a: c - a, corrected, applied)

    return qs, scales, new_err


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads, err_state, group=None):
    """Error-feedback int8 all-reduce over ``group`` (a
    ``torch.distributed`` process group; the default group when one is
    initialised).

    Each rank quantizes its corrected contribution; the reduction sums the
    dequantized tensors and divides by the group's size (wire bytes: 1/4
    of f32, 1/2 of bf16). ``group=None`` without an initialised process
    group is one rank: the mean is the local dequantized tree (the
    convention of ``core.zebra_spmd.EPGroup``). Returns (mean_grads,
    new_err_state)."""
    qs, scales, new_err = compress_tree(grads, err_state)
    local_hat = _tree_map2(decompress, qs, scales)
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return local_hat, new_err(local_hat)
    n = dist.get_world_size(group)

    def reduce(x):
        s = x.clone()
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        return s / s.new_tensor(float(n))

    return tree_map(reduce, local_hat), new_err(local_hat)
