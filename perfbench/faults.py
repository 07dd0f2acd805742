"""Faults a training cell can have, each a step function put in the
program's place (``fault(program)`` -> ``step(params, opt_state,
batch)``): the check has to come out not correct under each. Used by the
calibration (:mod:`perfbench.calibrate`) and the harness's tests, never by
a benchmark run."""

from __future__ import annotations

import torch


def unchanged(program):
    """A step that computes the gradient and returns its state as it was
    given."""
    def step(params, opt_state, batch):
        _, met = program.grad_fn(params, batch)
        return params, opt_state, dict(met, grad_norm=torch.zeros(()))
    return step


def half_batch(program):
    """A step on the first half of the batch's rows only: the loss and
    gradient are the mean over the rest."""
    def step(params, opt_state, batch):
        n = batch["tokens"].shape[0] // 2
        return program.train_step(params, opt_state,
                                  {k: v[:n] for k, v in batch.items()})
    return step


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
