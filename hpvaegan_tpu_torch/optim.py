"""Optimizers: Adam with a per-tensor clip by norm for G, plain Adam for D.

The port of the JAX package's `optim.py` (reference ClippedAdam,
src/modules/optimizers.py:6-43, and nn.Adam, train_image.py:42). The clip is
per TENSOR, as `optim.py:20-37` there: each gradient is scaled by
min(1, clip / max(||g||, 1e-12)) on its own, not by the global norm of
`clip_grad_norm_`. `torch.optim.Adam`'s update, lr * (m / (1 - b1^t)) /
(sqrt(v) / sqrt(1 - b2^t) + eps), is optax `scale_by_adam` followed by -lr
in another order of the same algebra; tests/test_torch_training.py holds the
two together on identical gradients.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import torch

BETA2 = 0.999
EPS = 1e-8


class ClippedAdam(torch.optim.Adam):
    """G optimizer: Adam after clipping each parameter's gradient to norm
    `grad_clip`, one param group per learning rate of the plan
    (training/partition.py::param_groups). A non-finite clip skips the clip
    (the JAX package's unclipped form)."""

    def __init__(self, param_groups: Iterable[Dict], beta1: float,
                 grad_clip: float = 5.0):
        super().__init__(param_groups, betas=(beta1, BETA2), eps=EPS)
        self.grad_clip = float(grad_clip)

    @torch.no_grad()
    def clip_(self) -> None:
        """Scale every gradient in place, with no read back to the host."""
        grads: List[torch.Tensor] = [p.grad for g in self.param_groups
                                     for p in g["params"] if p.grad is not None]
        if not grads or not math.isfinite(self.grad_clip):
            return
        norms = torch.stack(torch._foreach_norm(grads))
        scales = torch.clamp(self.grad_clip / torch.clamp_min(norms, 1e-12),
                             max=1.0)
        for grad, scale in zip(grads, scales.unbind()):
            grad.mul_(scale)

    def step(self, closure=None):
        self.clip_()
        return super().step(closure)


def adam(params, lr: float, beta1: float) -> torch.optim.Adam:
    """D optimizer (reference nn.Adam, train_image.py:42)."""
    return torch.optim.Adam(params, lr=lr, betas=(beta1, BETA2), eps=EPS)
