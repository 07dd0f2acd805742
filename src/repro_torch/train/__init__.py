"""Training: losses, AdamW and the one-device train step (mirror of
``repro/train``)."""

from repro_torch.train import loss, optimizer, step

__all__ = ["loss", "optimizer", "step"]
