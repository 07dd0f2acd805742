"""The model of a configuration file, as the benchmark reads it: sizes, the
parameter tree's layout (the port's leaf paths, stacked over layers) and
the benchmark's own seeded weight draw.

The layout is the benchmark's statement of the tree; the driver checks
that the program built the same one (``TrainProgram.layout.shapes``)
before it hands the program these weights."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """A Mixtral-style decoder: pre-norm GQA attention with RoPE, a
    top-k softmax router over ``n_experts`` SwiGLU experts, untied head."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    n_experts: int
    top_k: int
    vocab: int
    rope_theta: float
    norm_eps: float
    router_aux_coef: float
    router_z_coef: float
    lm_z_coef: float
    capacity_factor: float

    @classmethod
    def from_config(cls, c: dict) -> "MoESpec":
        if c.get("architecture") != "mixtral":
            raise ValueError(f"unknown architecture {c.get('architecture')}")
        if c.get("tie_word_embeddings") or c.get("hidden_act") != "silu":
            raise ValueError("mixtral has an untied head and SwiGLU experts")
        a = c["assumed"]
        return cls(name=c["name"], n_layers=c["num_hidden_layers"],
                   d_model=c["hidden_size"],
                   n_heads=c["num_attention_heads"],
                   n_kv_heads=c["num_key_value_heads"],
                   head_dim=c["head_dim"], d_ff=c["intermediate_size"],
                   n_experts=c["num_local_experts"],
                   top_k=c["num_experts_per_tok"], vocab=c["vocab_size"],
                   rope_theta=float(c["rope_theta"]),
                   norm_eps=float(c["rms_norm_eps"]),
                   router_aux_coef=float(c["router_aux_loss_coef"]),
                   router_z_coef=float(a["router_z_loss_coef"]),
                   lm_z_coef=float(a["lm_z_loss_coef"]),
                   capacity_factor=float(a["capacity_factor"]))

    def layout(self) -> dict:
        """{leaf path: (shape, fan_in)}, fan_in 0 for a norm scale (ones).
        Paths and order are the port's parameter tree (``embed/table``,
        ``blocks/pos0/...`` stacked over the layers, ``final_norm``,
        ``lm_head``)."""
        L, d, H, KH, hd = (self.n_layers, self.d_model, self.n_heads,
                           self.n_kv_heads, self.head_dim)
        E, f, V = self.n_experts, self.d_ff, self.vocab
        b = "blocks/pos0/"
        return {
            "embed/table": ((V, d), d),
            b + "norm1/scale": ((L, d), 0),
            b + "mixer/wq": ((L, d, H * hd), d),
            b + "mixer/wk": ((L, d, KH * hd), d),
            b + "mixer/wv": ((L, d, KH * hd), d),
            b + "mixer/wo": ((L, H * hd, d), H * hd),
            b + "norm2/scale": ((L, d), 0),
            b + "ffn/router": ((L, d, E), d),
            b + "ffn/wi_gate": ((L, E, d, f), d),
            b + "ffn/wi_up": ((L, E, d, f), d),
            b + "ffn/wo": ((L, E, f, d), f),
            "final_norm/scale": ((d,), 0),
            "lm_head": ((V, d), d),
        }

    def n_params(self) -> int:
        return sum(math.prod(s) for s, _ in self.layout().values())


def leaf_seed(seed: int, i: int) -> int:
    """The generator seed of leaf ``i`` under run seed ``seed`` (any whole
    number: the driver's seeds exceed 32 bits)."""
    return (int(seed) * 1_000_003 + 7919 * (i + 1)) % (2 ** 63 - 1)


def draw_leaf(spec: MoESpec, seed: int, path: str, device) -> torch.Tensor:
    """One f32 leaf of the seeded draw: a norm scale is ones, a matrix
    normal(0, 1 / fan_in) from its own generator on ``device`` (one call
    per leaf, so a leaf can be drawn again alone)."""
    names = list(spec.layout())
    shape, fan_in = spec.layout()[path]
    if fan_in == 0:
        return torch.ones(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, names.index(path)))
    t = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    return t.mul_(1.0 / math.sqrt(fan_in))


def draw_weights(spec: MoESpec, seed: int, device) -> dict:
    """{path: f32 leaf} of the whole tree."""
    return {p: draw_leaf(spec, seed, p, device) for p in spec.layout()}


def nest(flat: dict) -> dict:
    """{'a/b/c': t} -> {'a': {'b': {'c': t}}} (the program's tree)."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out
