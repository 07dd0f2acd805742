"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings of the first steps from the seed's
weights on the same batches: each step's loss, each leaf's first gradient
as the optimizer got it (from Adam's first moment after one step: mu /
(1 - b1), the clipped gradient) and each leaf's change after the last
checked step, as norms and as a fixed sample of 2^20 elements a leaf.
Four numbers follow, each held to its own limit:

* ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the steps;
* ``grad_gap``: over the leaves, the largest gap between the two norms of
  the first gradient, over the reference's norm of that leaf or of the
  median leaf, whichever is larger (some gradients are all but zero);
* ``update_gap``: the same of the change after the last step, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (a leaf whose gradient is nought to rounding moves under Adam by
  round-off alone);
* ``grad_diff``: over the leaves, the median of |first gradient -
  reference's| / max(|reference's|, the median leaf's) on the sampled
  elements. The three gaps above swing with the router's discrete
  choices, which any rounding below f32 moves; this one is steady from
  seed to seed and tells the configuration's bfloat16 from the 8-bit
  control.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "update_gap", "grad_diff")


SAMPLE = 1 << 20  # elements of a leaf that the difference numbers read


@dataclasses.dataclass
class Readings:
    losses: list
    grads: dict     # {leaf: norm of the first clipped gradient}
    changes: dict   # {leaf: norm of the change after the checked steps}
    grad_samples: dict = dataclasses.field(default_factory=dict)
    change_samples: dict = dataclasses.field(default_factory=dict)


def sample_index(numel: int, leaf: int):
    """The elements of a flattened leaf that both sides sample: a fixed
    draw from the leaf's size and position alone (CPU int64)."""
    import torch
    g = torch.Generator().manual_seed(1000 + leaf)
    if numel <= SAMPLE:
        return torch.arange(numel)
    return torch.randint(numel, (SAMPLE,), generator=g)


def sample(t, leaf: int, idx_cache: dict):
    """The sampled elements of ``t`` as f32 on the CPU."""
    key = (t.numel(), leaf)
    if key not in idx_cache:
        idx_cache[key] = sample_index(t.numel(), leaf).to(t.device)
    return t.detach().reshape(-1)[idx_cache[key]].float().cpu()


def _worst(side: dict, ref: dict, keys) -> tuple:
    floor = statistics.median(ref[k] for k in keys)
    worst, leaf = 0.0, None
    for k in keys:
        gap = abs(side[k] - ref[k]) / max(ref[k], floor)
        if not math.isfinite(gap):
            return math.inf, k
        if gap >= worst:
            worst, leaf = gap, k
    return worst, leaf


def gaps(side: Readings, ref: Readings) -> dict:
    """{number: (value, worst leaf or step)}."""
    if len(side.losses) != len(ref.losses):
        return {n: (math.inf, "steps") for n in NUMBERS}
    loss = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(side.losses, ref.losses)]
    step = max(range(len(loss)), key=lambda i: loss[i])
    med = statistics.median(ref.grads.values())
    moving = [k for k in ref.grads if ref.grads[k] >= 1e-3 * med]
    out = {"loss_gap": (loss[step], f"step {step + 1}"),
           "grad_gap": _worst(side.grads, ref.grads, list(ref.grads)),
           "update_gap": _worst(side.changes, ref.changes, moving)}
    d = diffs(side.grad_samples, ref.grad_samples, list(ref.grads))
    leaf = sorted(d, key=d.get)[(len(d) - 1) // 2]
    out["grad_diff"] = (statistics.median(d.values()), f"median, {leaf}")
    return out


def diffs(side: dict, ref: dict, keys) -> dict:
    """{leaf: |a - b| / max(|b|, the median leaf's |b|)} over the sampled
    elements."""
    norms = {k: float(ref[k].norm()) for k in keys}
    floor = statistics.median(norms.values())
    return {k: float((side[k] - ref[k]).norm()) / max(norms[k], floor)
            for k in keys}


def verdict(side: Readings, ref: Readings, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit", "at"}})."""
    out, ok = {}, True
    for name, (value, at) in gaps(side, ref).items():
        limit = float(limits[name])
        out[name] = {"value": value, "limit": limit, "at": at}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, out
