"""Input stand-ins and concrete batches for every (arch x shape) (mirror
of ``repro/configs/inputs.py``).

``input_specs`` is the dry run's contract (``launch/dryrun.py``): the
names, shapes and dtypes of one cell's inputs, nothing allocated. The
modality fronts are stubbed as in the JAX package: whisper takes
precomputed mel-frame embeddings, the vision archs precomputed patch
embeddings (:func:`front_specs`).

``make_batch`` draws a batch of the same structure from an explicit
``torch.Generator``, one name after another in the specs' order. The JAX
version folds ``hash(name)`` into its key (``inputs.py:45``); that hash is
salted per process (PYTHONHASHSEED), so its values change between
processes and only the structure can be held against it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class Spec:
    """Shape and dtype of one input (``jax.ShapeDtypeStruct``'s role)."""

    shape: tuple
    dtype: torch.dtype


def _shape(shape_or_name) -> ShapeConfig:
    if isinstance(shape_or_name, str):
        return SHAPES[shape_or_name]
    return shape_or_name


def front_specs(cfg: ModelConfig, batch: int,
                compute_dtype=torch.bfloat16) -> dict:
    """The front embeddings of a batch of ``batch`` rows: ``encoder_embeds``
    [batch, encoder_seq, d] for an encoder-decoder arch, ``vision_embeds``
    [batch, vision_seq, vision_dim] for a vision arch, nothing for a
    decoder-only one."""
    specs = {}
    if cfg.is_encdec:
        specs["encoder_embeds"] = Spec((batch, cfg.encoder_seq, cfg.d_model),
                                       compute_dtype)
    if cfg.vision_seq > 0:
        specs["vision_embeds"] = Spec(
            (batch, cfg.vision_seq, cfg.vision_dim or cfg.d_model),
            compute_dtype)
    return specs


def input_specs(cfg: ModelConfig, shape_or_name,
                compute_dtype=torch.bfloat16) -> dict:
    """{name: Spec} of one input-shape cell: ``tokens`` [B, S] int32 (S 1
    for decode), ``targets`` for train, and the fronts."""
    sc = _shape(shape_or_name)
    B = sc.global_batch
    S = 1 if sc.kind == "decode" else sc.seq_len
    specs = {"tokens": Spec((B, S), torch.int32)}
    if sc.kind == "train":
        specs["targets"] = Spec((B, S), torch.int32)
    specs.update(front_specs(cfg, B, compute_dtype))
    return specs


def make_batch(generator: torch.Generator, cfg: ModelConfig, shape_or_name,
               compute_dtype=torch.bfloat16, device="cpu") -> dict:
    """Random batch with the structure of :func:`input_specs`: token ids
    uniform in [0, vocab), fronts standard normal, drawn from
    ``generator`` in the specs' order."""
    out = {}
    for name, spec in input_specs(cfg, shape_or_name, compute_dtype).items():
        if spec.dtype.is_floating_point:
            out[name] = torch.randn(spec.shape, generator=generator,
                                    device=device).to(spec.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=generator, device=device,
                                      dtype=spec.dtype)
    return out
