"""Convolution helpers on NCHW tensors with OIHW weights.

The port of the JAX package's `ops/conv.py` for the 2D sampling path. The JAX
package keeps HWIO weights and NHWC activations; the port keeps PyTorch's
layouts, and tools/convert.py carries weights across. The convolutions
themselves are `F.conv2d` (cuDNN on the card), as XLA ran them outside any
Pallas kernel in the JAX package.
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


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with MindSpore's default slope 0.2 (reference
    networks_2d.py:16-24), the activation of every block of this slice."""
    return F.leaky_relu(x, 0.2)
