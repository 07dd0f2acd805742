"""Checkpointing of the port (mirror of ``repro/checkpoint``): the JAX
package's npz + manifest format, atomic publish, async save."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
