"""Shared 2D building blocks as `nn.Module`s on NCHW tensors.

The port of the JAX package's `models/blocks.py` (reference
src/modules/networks_2d.py:44-82):
  ConvBlock = Conv(Normal 0.02) + BatchNorm(gamma ~ N(1, 0.02)) + LeakyReLU(0.2)
  ConvStack = head block + num_layer blocks + plain conv tail
  SNConv2d  = the parameters of a spectral-norm conv
Module and parameter names follow the original hp-vae-gan state_dict
(`head`, `block<i>`, `tail`, `conv`, `norm`, `weight_orig`, ...), which is
also what the JAX package's tools/convert.py reads and writes.

BatchNorm is ops/norm.py's function with the state as buffers; its mode is
an argument of every forward ("batch", "moving" or "sample"). In "batch"
mode the forward folds the batch statistics into the buffers in place.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.conv import conv2d, lrelu
from ..ops.norm import batchnorm


class Conv2d(nn.Module):
    """Plain conv: weight (O, I, k, k), bias (O,)."""

    def __init__(self, cin: int, cout: int, ker: int, padding: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, ker, ker))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, padding=self.padding)


class BatchNorm2d(nn.Module):
    """gamma/beta as `weight`/`bias`, moving stats as buffers."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        y, mean, var = batchnorm(x, self.weight, self.bias, self.running_mean,
                                 self.running_var, mode)
        if mode == "batch":
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return y


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, ker: int, padding: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, ker, padding)
        self.norm = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor, bn: str) -> torch.Tensor:
        return lrelu(self.norm(self.conv(x), bn))


class ConvStack(nn.Module):
    """head + num_layer blocks + tail conv: the decoder and every refinement
    stage (networks_2d.py:207-213, 224-235)."""

    def __init__(self, cin: int, mid: int, cout: int, ker: int, padd: int,
                 num_layer: int):
        super().__init__()
        self.head = ConvBlock(cin, mid, ker, padd)
        for i in range(num_layer):
            setattr(self, f"block{i}", ConvBlock(mid, mid, ker, padd))
        self.num_layer = num_layer
        self.tail = Conv2d(mid, cout, ker, ker // 2)

    def forward(self, x: torch.Tensor, bn: str) -> torch.Tensor:
        x = self.head(x, bn)
        for i in range(self.num_layer):
            x = getattr(self, f"block{i}")(x, bn)
        return self.tail(x)


class SNConv2d(nn.Module):
    """The parameters of a spectral-norm conv: `weight_orig`, `bias` and the
    power-iteration vectors `weight_u` (O,) and `weight_v` (I*k*k,). Its
    forward (one power step, then W / sigma) belongs to the training path
    and is not ported yet."""

    def __init__(self, cin: int, cout: int, ker: int):
        super().__init__()
        self.weight_orig = nn.Parameter(torch.zeros(cout, cin, ker, ker))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("weight_u", torch.zeros(cout))
        self.register_buffer("weight_v", torch.zeros(cin * ker * ker))


def init_weights_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """The JAX package's initialisation laws, drawn from `gen`: conv weights
    N(0, 0.02) and zero biases (ops/conv.py), BN gamma N(1, 0.02), beta 0,
    moving stats (0, 1) (ops/norm.py), unit-norm random SN vectors."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.02)
                m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape,
                                                        generator=gen))
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, SNConv2d):
                m.weight_orig.copy_(torch.randn(m.weight_orig.shape,
                                                generator=gen) * 0.02)
                m.bias.zero_()
                for buf in (m.weight_u, m.weight_v):
                    v = torch.randn(buf.shape, generator=gen)
                    buf.copy_(v / v.norm().clamp_min(1e-12))
    return module
