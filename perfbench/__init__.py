"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: training
cells run on the card, timed on the host clock, traced with
``torch.profiler``, and checked against a plain PyTorch reference.

Run one cell from the root of a checkout::

    python3 perfbench/run.py --workload w1.zebra.4k --seed 7 --seconds 30 \\
        --trace 0

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic mix, ``configs/<config>.json`` holds the
model's sizes, ``traffic/<traffic>.json`` the job's parameters (read by
the one generator in :mod:`perfbench.gen` and run by
``drivers/<kind>.py``), ``workloads/<cell>.json`` the limits of its
correctness check, and ``metrics/<metric>.py`` one reader per per-layer
metric. Nothing here imports ``jax`` or the JAX package.
"""
