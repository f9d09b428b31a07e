"""Convolution helpers on NCHW / NCDHW tensors with OIHW / OIDHW weights.

The port of the JAX package's `ops/conv.py`. The JAX package keeps HWIO /
DHWIO weights and channels-last activations; the port keeps PyTorch's
layouts, and tools/convert.py carries weights across. The convolutions
themselves are `F.conv2d` / `F.conv3d` (cuDNN on the card), as XLA ran them
outside any Pallas kernel in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Plain 2D convolution, zero padding (reference networks_2d.py:47-49)."""
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)


def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Plain 3D convolution, zero padding (reference networks_3d.py:48-50)."""
    return F.conv3d(x, weight, bias, stride=stride, padding=padding)


def conv(x: torch.Tensor, weight: torch.Tensor,
         bias: Optional[torch.Tensor] = None, stride: int = 1,
         padding: int = 0) -> torch.Tensor:
    """conv2d or conv3d, by the weight's rank (OIHW or OIDHW)."""
    fn = conv2d if weight.ndim == 4 else conv3d
    return fn(x, weight, bias, stride=stride, padding=padding)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with MindSpore's default slope 0.2 (reference
    networks_2d.py:16-24), the activation of every block of the port."""
    return F.leaky_relu(x, 0.2)
