"""BatchNorm as a function of explicit (mean, var) state, on NCHW or NCDHW
tensors.

The port of the JAX package's `ops/norm.py`. MindSpore semantics, which the JAX
package keeps and `nn.BatchNorm2d` does not: the moving statistics fold the
BIASED batch variance, as `moving = 0.9 * moving + 0.1 * batch`, and eps is
1e-5.

Three modes:
  * "batch":  statistics of the whole batch, over (0, 2, ...); returns the
    folded moving stats.
  * "moving": the carried moving statistics; state unchanged.
  * "sample": statistics over the spatial (and time) axes (2, ...) of each
    sample on its own. One batched forward in this mode equals the JAX
    sampler's vmap of batch-1 train-mode forwards (parallel/sampling.py:73-82
    there); the moving stats those forwards would fold are discarded, so
    state is unchanged.
"""

from __future__ import annotations

from typing import Tuple

import torch

BN_MODES = ("batch", "moving", "sample")


def batchnorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              mean: torch.Tensor, var: torch.Tensor, mode: str,
              momentum: float = 0.9, eps: float = 1e-5
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, C, H, W) or (B, C, T, H, W). Returns (y, new_mean, new_var)."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    spatial = tuple(range(2, x.ndim))
    if mode == "batch":
        b_mean = x.mean(dim=(0,) + spatial)
        b_var = x.var(dim=(0,) + spatial, unbiased=False)
        new_mean = momentum * mean + (1 - momentum) * b_mean
        new_var = momentum * var + (1 - momentum) * b_var
        inv = torch.rsqrt(b_var + eps) * gamma
        y = (x - b_mean.reshape(shape)) * inv.reshape(shape) + beta.reshape(shape)
        return y, new_mean, new_var
    if mode == "moving":
        inv = torch.rsqrt(var + eps) * gamma
        y = (x - mean.reshape(shape)) * inv.reshape(shape) + beta.reshape(shape)
        return y, mean, var
    if mode == "sample":
        s_mean = x.mean(dim=spatial, keepdim=True)  # (B, C, 1, 1[, 1])
        s_var = x.var(dim=spatial, unbiased=False, keepdim=True)
        inv = torch.rsqrt(s_var + eps) * gamma.reshape(shape)
        y = (x - s_mean) * inv + beta.reshape(shape)
        return y, mean, var
    raise ValueError(f"unknown batchnorm mode {mode!r} (have {BN_MODES})")
