"""PyTorch + CUDA port of the HeterMoE reproduction (``src/repro``).

Module paths mirror the JAX package (``repro/kernels/gmm.py`` ->
``repro_torch/kernels/gmm.py``). The port never imports ``jax`` or anything
under ``repro``: jax-free reference modules are copied in with their
imports rewritten. Hand-written CUDA kernels live in ``csrc/`` and are built
at first use by :mod:`repro_torch.kernels._build`.
"""
