"""Spectral normalisation with one power step, the (u, v) vectors explicit.

The port of the JAX package's `ops/spectral_norm.py` (reference
src/tools/spectral_norm.py:44-55). Each application runs one power step on
detached u and v, computes sigma = u^T W v (differentiable in W) and returns
W / sigma with the new pair. Nothing is written back: the caller decides
whether the pair is kept, which is how the training step keeps the real
pass's update of the discriminator and discards the others
(training/steps.py). `nn.utils.spectral_norm` is not used: it advances u in
place on every forward.

Weights are OIHW (OIDHW in 3D), so W_mat = w.reshape(cout, -1) flattens
fan-in as (I, [KD,] KH, KW); v lives in that flattening (tools/convert.py
re-permutes it against the JAX package's ([KD,] KH, KW, I)), and W_mat @ v
pairs the same entries as the JAX package's product.
"""

from __future__ import annotations

from typing import Tuple

import torch


def l2normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x), eps)


def spectral_normalize(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """w (cout, cin, *k), u (cout,), v (cin * prod(k),) -> (w / sigma, u, v)."""
    w_mat = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        w_const = w_mat.detach()
        v = l2normalize(w_const.t() @ u)
        u = l2normalize(w_const @ v)
    sigma = u @ w_mat @ v  # differentiable in w
    return w / sigma, u, v
