"""Logical-axis -> mesh-axis sharding rules (mirror of
``repro/sharding/rules.py``, without jax).

Params carry logical axis names (``pytree.ParamSpec.axes``); these rules
map them onto the mesh axes ("pod", "data", "model"). Weight rules and
activation rules are separate: weights are 2D-sharded (FSDP, gathered at
use) whatever the computation's own parallelism.

Variants (the JAX package's, unchanged):
  * dense / ssm / hybrid / audio / vlm -- "default" (FSDP): token batch
    over ALL mesh axes, weights 2D-sharded over (data x model),
    activations data-parallel. "tp" keeps Megatron tensor parallelism over
    "model" for comparison.
  * moe -- "ep": experts along "model", batch over (data x model),
    attention data-parallel with FSDP weights. "hybrid": TP attention + EP
    experts, batch over data only (zebra microbatching at full-pod scale).
  * "serve": "model" carries TP / SP for activations; weights stay 2D.

A spec is a tuple with one entry per tensor dim: None, a mesh-axis name,
or a tuple of names (``tuple(jax.sharding.PartitionSpec)``). A mesh is any
object with ``axis_names`` and a ``shape`` mapping of name -> size
(:class:`MeshShape`, ``launch.mesh.Mesh``, or the JAX package's Mesh).
:func:`placements` turns a spec into DTensor placements, and
:func:`local_shape` / :func:`local_slice` give a rank's block, in the
JAX package's block order (mesh coordinates row-major; a dim over several
axes is split outermost-first).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

from repro_torch.models.config import ModelConfig

# Weights: 2D FSDP sharding for every big matrix.
_W_FSDP = {
    "vocab": "model", "embed": "data",
    "q_heads": "model", "kv_heads": "model",
    "mlp": "model", "mlp_out": "data",
    "expert": "model", "layers": None,
}
# Activations: pure data parallel.
_A_DP = {"q_heads": None, "kv_heads": None, "mlp": None, "vocab": None,
         "seq": None}
# Activations: Megatron-style TP over "model" (+ sequence-parallel layer
# boundaries on the same axis).
_A_TP = {"q_heads": "model", "kv_heads": "model", "mlp": "model",
         "vocab": "model", "seq": "model"}


class MeshShape:
    """A mesh's axis names and sizes, with no devices or process groups
    (the rules and the block arithmetic need nothing else)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        return self.size_of(self.axis_names)

    def size_of(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name, names or None)."""
        axes = () if axes is None else \
            ((axes,) if isinstance(axes, str) else tuple(axes))
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Weight + activation logical-axis maps and batch axes."""

    rules: Mapping[str, object]          # weight axes
    act_rules: Mapping[str, object]      # activation axes
    batch_axes: tuple                    # token batch dim mesh axes

    def mesh_axes(self, logical: Optional[str]):
        if logical is None:
            return None
        return self.rules.get(logical, None)

    def act_axes(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == "batch":
            return self.batch_axes or None  # () -> replicated (e.g. B=1)
        return self.act_rules.get(logical, None)

    def spec(self, axes: Sequence[Optional[str]]) -> tuple:
        return tuple(self.mesh_axes(a) for a in axes)


def rules_for(cfg: ModelConfig, mesh, variant: str = "default") \
        -> ShardingRules:
    names = mesh.axis_names
    has_pod = "pod" in names
    data_axes = ("pod", "data") if has_pod else ("data",)
    all_axes = data_axes + ("model",)

    if variant == "serve":
        w = dict(_W_FSDP)
        if cfg.is_moe:
            w["mlp"] = None
        return ShardingRules(rules=w, act_rules=dict(_A_TP),
                             batch_axes=data_axes)

    if cfg.is_moe:
        # expert dim takes "model"; expert matrices keep "embed"->data only
        # (a dim may not repeat a mesh axis within one spec).
        w = dict(_W_FSDP, mlp=None)
        if variant in ("default", "ep"):
            return ShardingRules(rules=w, act_rules=dict(_A_DP),
                                 batch_axes=all_axes)
        # hybrid: TP attention + EP experts; batch over data only.
        w = dict(w, embed=None)
        return ShardingRules(rules=w, act_rules=dict(_A_TP),
                             batch_axes=data_axes)

    if variant == "tp":
        w = dict(_W_FSDP, embed=None, mlp_out=None)
        return ShardingRules(rules=w, act_rules=dict(_A_TP),
                             batch_axes=data_axes)
    return ShardingRules(rules=dict(_W_FSDP), act_rules=dict(_A_DP),
                         batch_axes=all_axes)


def specs_for(axes_tree, rules: ShardingRules):
    """{path: logical axes} (or a nested dict of them) -> the same tree of
    unfitted specs."""
    if isinstance(axes_tree, dict):
        return {k: specs_for(v, rules) for k, v in axes_tree.items()}
    return rules.spec(axes_tree)


def _fit_axis(dim: int, ax, mesh):
    """Longest prefix of mesh axes whose product divides ``dim`` (odd
    vocabularies etc. fall back to fewer axes or replication)."""
    if ax is None:
        return None
    axs = ax if isinstance(ax, tuple) else (ax,)
    keep = []
    prod = 1
    for a in axs:
        if dim % (prod * mesh.shape[a]) == 0:
            keep.append(a)
            prod *= mesh.shape[a]
        else:
            break
    if not keep:
        return None
    return tuple(keep) if len(keep) > 1 else keep[0]


def fit_spec(shape, mesh, parts) -> tuple:
    """Drop non-dividing mesh axes from a proposed spec, per dim."""
    return tuple(_fit_axis(d, a, mesh) for d, a in zip(shape, parts))


def fitted_specs(shapes: Mapping[str, tuple], axes: Mapping[str, tuple],
                 rules: ShardingRules, mesh) -> dict:
    """{path: spec}: logical axes -> mesh axes, fitted per dim against the
    leaf's shape (the JAX package's ``fitted_shardings``)."""
    return {k: fit_spec(shapes[k], mesh,
                        [rules.mesh_axes(x) for x in axes[k]])
            for k in shapes}


def ep_ffn_specs(ep_axis: str, offload: bool = False) -> dict:
    """Specs of a zebra EP MoE FFN's param dict: router replicated, the
    [E_remote, ...] expert stacks sharded over the EP axis; with an
    Asym-EA offload, the local experts under the ``*_loc`` keys replicated
    across it."""
    specs = {"router": (None, None)}
    for k in ("wi_gate", "wi_up", "wo"):
        specs[k] = (ep_axis, None, None)
        if offload:
            specs[k + "_loc"] = (None, None, None)
    return specs


def slot_vector_spec(batch: int, mesh, rules: ShardingRules) -> tuple:
    """Spec of per-slot serving vectors [B]: the token batch's axes,
    divisibility-fitted."""
    if not rules.batch_axes:
        return (None,)
    return (_fit_axis(batch, tuple(rules.batch_axes), mesh),)


def page_table_spec(batch: int, mesh, rules: ShardingRules) -> tuple:
    """Spec of per-slot page tables [B, max_pages]: slots over the batch
    axes, the page dim replicated."""
    if not rules.batch_axes:
        return (None, None)
    return (_fit_axis(batch, tuple(rules.batch_axes), mesh), None)


def paged_pool_spec(n_pages: int, mesh, rules: ShardingRules,
                    ndim: int = 4) -> tuple:
    """Spec of the physical KV pools [n_pages, page_size, KH, hd] (and
    the [n_pages, page_size] position pool with ndim=2): the PAGE dim over
    "model"."""
    del rules
    return (_fit_axis(n_pages, "model", mesh),) + (None,) * (ndim - 1)


def transfer_payload_spec(ndim: int) -> tuple:
    """Spec of a KV-handoff page payload [n, page_size, ...]: replicated."""
    return (None,) * ndim


def batch_spec(rules: ShardingRules, ndim: int, *, seq_axis=None) -> tuple:
    """Spec of token-shaped arrays [batch, seq, ...]."""
    parts = [rules.batch_axes] + [None] * (ndim - 1)
    if seq_axis is not None and ndim >= 2:
        parts[1] = seq_axis
    return tuple(parts)


# ---------------------------------------------------------------------------
# Blocks: a rank's share of a spec'd array
# ---------------------------------------------------------------------------

def entry_axes(entry) -> tuple:
    """A spec entry as a tuple of mesh-axis names (() for None)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec shards over, in spec order."""
    return tuple(a for e in spec for a in entry_axes(e))


def coords(mesh, rank: int) -> dict:
    """{axis: coordinate} of ``rank``: mesh coordinates row-major over
    ``axis_names`` (JAX's device order on a ``make_mesh`` mesh)."""
    out = {}
    for a in reversed(mesh.axis_names):
        out[a] = rank % mesh.shape[a]
        rank //= mesh.shape[a]
    return {a: out[a] for a in mesh.axis_names}


def block_index(entry, mesh, rank: int) -> tuple:
    """(index, count) of ``rank``'s block along one dim: the dim's axes
    split it outermost-first."""
    c = coords(mesh, rank)
    idx, n = 0, 1
    for a in entry_axes(entry):
        idx = idx * mesh.shape[a] + c[a]
        n *= mesh.shape[a]
    return idx, n


def local_shape(spec, shape, mesh) -> tuple:
    """The block shape of a ``shape`` array under ``spec`` (the JAX
    package's ``NamedSharding.shard_shape``); each dim must divide."""
    out = []
    for d, e in zip(shape, spec):
        n = 1
        for a in entry_axes(e):
            n *= mesh.shape[a]
        if d % n:
            raise ValueError(f"dim {d} does not divide over {e} ({n})")
        out.append(d // n)
    return tuple(out) + tuple(shape[len(spec):])


def local_slice(spec, mesh, rank: int, full):
    """``rank``'s block of the full array ``full`` (a view where the
    array type gives one)."""
    out = full
    for dim, e in enumerate(spec):
        i, n = block_index(e, mesh, rank)
        if n > 1:
            size = full.shape[dim] // n
            sl = [slice(None)] * full.ndim
            sl[dim] = slice(i * size, (i + 1) * size)
            out = out[tuple(sl)]
    return out


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on a DeviceMesh over
    ``mesh.axis_names``: one per mesh dim, ``Shard(d)`` where tensor dim d
    is split over that axis, else ``Replicate()``. A dim over several axes
    is sharded on each, outermost first, as JAX orders its blocks."""
    from torch.distributed.tensor import Replicate, Shard
    out = {a: Replicate() for a in mesh.axis_names}
    for d, e in enumerate(spec):
        for a in entry_axes(e):
            out[a] = Shard(d)
    return tuple(out[a] for a in mesh.axis_names)
