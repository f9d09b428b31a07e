"""The training state of one pyramid scale (the port of the JAX package's
`training/state.py::ScaleTrainState`): the modules and optimizers hold
their own tensors, and the NoiseSource stands in for the PRNG key."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.noise import NoiseSource


@dataclass
class ScaleTrainState:
    G: torch.nn.Module
    D: torch.nn.Module
    opt_g: torch.optim.Optimizer  # ClippedAdam, or FlatAdam (--flat-opt)
    opt_d: torch.optim.Optimizer  # Adam, or FlatAdam
    noise: NoiseSource
