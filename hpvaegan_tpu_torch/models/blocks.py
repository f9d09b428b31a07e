"""Shared 2D / 3D building blocks as `nn.Module`s on NCHW / NCDHW tensors.

The port of the JAX package's `models/blocks.py` (reference
src/modules/networks_2d.py:44-82, networks_3d.py:45-86):
  ConvBlock = Conv(Normal 0.02) + BatchNorm(gamma ~ N(1, 0.02)) + LeakyReLU(0.2)
  ConvStack = head block + num_layer blocks + plain conv tail
  SNConv    = spectral-norm conv (ops/spectral_norm.py), (u, v) as buffers
  SNBlock   = SNConv + LeakyReLU(0.2) (the reference's ConvBlockSN, bn=True)
`ndim` is 2 for images (OIHW weights) and 3 for videos (OIDHW, kept
ODHWI in memory from the start: ops/layout.py; load_state_dict copies
into them and keeps it).
Module and parameter names follow the original hp-vae-gan state_dict
(`head`, `block<i>`, `tail`, `conv`, `norm`, `weight_orig`, ...), which is
also what the JAX package's tools/convert.py reads and writes.

BatchNorm is ops/norm.py's function with the state as buffers; its mode is
an argument of every forward ("batch", "moving" or "sample"). In "batch"
mode the forward folds the batch statistics into the buffers in place,
unless it is called with commit=False: the training step's forwards whose
new state the JAX package discards (the D step's fake, the calibration)
pass that. The fold of a later pass lands on the earlier one's, which is
the JAX package's state threading, since batch-mode outputs do not read
the buffers. A `DeferredFolds` list as `commit` keeps the batch statistics
for a fold later (`DeferredFolds.apply`): the fused D/G iteration folds its
one fake forward after the reconstruction, as the JAX package threads it.
`groups` (batch mode only) normalises equal parts of the batch on their
own statistics and folds them in order (ops/norm.py), for the paired
forward.

`sharded` (an argument of every forward, False by default) says that the
activation holds this rank's rows of an H split over the spatial axis
(parallel/spatial.py): the convolutions then pad H with their neighbours'
rows and BatchNorm's statistics span the spatial ranks (ops/conv.py,
ops/norm.py). It is True for the equal split, or the input's padded
layout (spatial.Padded, the baselines'), which a padding-0 convolution
shrinks (`Conv.layout_after`): a ConvBlock's BatchNorm takes its conv's
output layout. Spectral norm acts on the replicated weights and needs
nothing.

`compute_dtype` (None, or bfloat16 under `--compute-dtype bfloat16`) is an
attribute of every Conv and SNConv, set by `set_compute_dtype`; the
training state sets it from cfg.compute_dtype (`cfg_compute_dtype`), and
nothing else does, so evaluation samples in float32 whatever args.txt says,
as the JAX package's does. Parameters and buffers stay float32.

Spectral-norm forwards never write their buffers: they return the new
(u, v) pairs, and `assign_sn_state` keeps them where a step does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ..ops.layout import to_port
from ..ops.conv import conv, lrelu
from ..ops.norm import batch_stats, batchnorm, fold, normalize_batch
from ..ops.spectral_norm import spectral_normalize
from ..parallel import spatial


def _weight(cout: int, cin: int, ker: int, ndim: int) -> torch.Tensor:
    """A zero conv weight (cout, cin, ker, ...) in the port's layout."""
    return to_port(torch.zeros((cout, cin) + (ker,) * ndim))


class Conv(nn.Module):
    """Plain conv: weight (O, I, k, k) or (O, I, k, k, k), bias (O,) unless
    `bias` is False."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, cin: int, cout: int, ker: int, padding: int,
                 ndim: int = 2, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(_weight(cout, cin, ker, ndim))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.padding = padding

    def forward(self, x: torch.Tensor,
                sharded: spatial.Layout = False) -> torch.Tensor:
        return conv(x, self.weight, self.bias, padding=self.padding,
                    compute_dtype=self.compute_dtype, sharded=sharded)

    def layout_after(self, sharded: spatial.Layout) -> spatial.Layout:
        """The layout of this conv's output on an input in `sharded`."""
        return spatial.conv_layout(sharded, self.weight.shape[-1],
                                   self.padding)


class DeferredFolds(list):
    """Batch statistics of forwards run with this list as `commit`, folded
    into their BatchNorms' buffers by `apply`, in the order they ran."""

    @torch.no_grad()
    def apply(self) -> None:
        for bn, b_mean, b_var in self:
            mean, var = fold(bn.running_mean, bn.running_var, b_mean, b_var)
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
        self.clear()


Commit = Union[bool, DeferredFolds]


class BatchNorm(nn.Module):
    """gamma/beta as `weight`/`bias`, moving stats as buffers; any rank."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor, mode: str, commit: Commit = True,
                groups: int = 1,
                sharded: spatial.Layout = False) -> torch.Tensor:
        if mode != "batch":
            return batchnorm(x, self.weight, self.bias, self.running_mean,
                             self.running_var, mode, groups=groups,
                             sharded=sharded)[0]
        b_mean, b_var = batch_stats(x, groups, sharded)
        if isinstance(commit, DeferredFolds):
            commit.append((self, b_mean.detach(), b_var.detach()))
        elif commit:
            with torch.no_grad():
                mean, var = fold(self.running_mean, self.running_var,
                                 b_mean, b_var)
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return normalize_batch(x, self.weight, self.bias, b_mean, b_var)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, ker: int, padding: int,
                 ndim: int = 2):
        super().__init__()
        self.conv = Conv(cin, cout, ker, padding, ndim)
        self.norm = BatchNorm(cout)

    def forward(self, x: torch.Tensor, bn: str, commit: Commit = True,
                groups: int = 1,
                sharded: spatial.Layout = False) -> torch.Tensor:
        return lrelu(self.norm(self.conv(x, sharded), bn, commit, groups,
                               self.conv.layout_after(sharded)))


class ConvStack(nn.Module):
    """head + num_layer blocks + tail conv: the decoder and every refinement
    stage (networks_2d.py:207-213, 224-235; networks_3d.py:186-211)."""

    def __init__(self, cin: int, mid: int, cout: int, ker: int, padd: int,
                 num_layer: int, ndim: int = 2):
        super().__init__()
        self.head = ConvBlock(cin, mid, ker, padd, ndim)
        for i in range(num_layer):
            setattr(self, f"block{i}", ConvBlock(mid, mid, ker, padd, ndim))
        self.num_layer = num_layer
        self.tail = Conv(mid, cout, ker, ker // 2, ndim)

    def forward(self, x: torch.Tensor, bn: str, commit: Commit = True,
                groups: int = 1, sharded: bool = False) -> torch.Tensor:
        x = self.head(x, bn, commit, groups, sharded)
        for i in range(self.num_layer):
            x = getattr(self, f"block{i}")(x, bn, commit, groups, sharded)
        return self.tail(x, sharded)


class SNConv(nn.Module):
    """Spectral-norm conv (JAX ops/spectral_norm.py::sn_conv_apply):
    `weight_orig`, `bias`, and the power-iteration vectors `weight_u` (O,)
    and `weight_v` (I * k^ndim,) as buffers; zero padding ker // 2. The
    power iteration and W / sigma stay float32 under a compute dtype; only
    the conv runs in it (ops/spectral_norm.py:55-71 there)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, cin: int, cout: int, ker: int, ndim: int = 2):
        super().__init__()
        self.weight_orig = nn.Parameter(_weight(cout, cin, ker, ndim))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("weight_u", torch.zeros(cout))
        self.register_buffer("weight_v", torch.zeros(cin * ker ** ndim))
        self.padding = ker // 2

    def forward(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                sharded: spatial.Layout = False
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Conv with W / sigma from one power step on (u, v); returns the
        output and the new (u, v). The buffers are not written."""
        w, u, v = spectral_normalize(self.weight_orig, u, v)
        return conv(x, w, self.bias, padding=self.padding,
                    compute_dtype=self.compute_dtype, sharded=sharded), (u, v)


class SNBlock(nn.Module):
    """SN conv + LeakyReLU(0.2) (JAX models/blocks.py::sn_block_apply), on
    the (u, v) held in its buffers."""

    def __init__(self, cin: int, cout: int, ker: int, ndim: int = 2):
        super().__init__()
        self.conv = SNConv(cin, cout, ker, ndim)

    def forward(self, x: torch.Tensor, sharded: spatial.Layout = False):
        y, uv = self.conv(x, self.conv.weight_u, self.conv.weight_v, sharded)
        return lrelu(y), uv


SNState = List[Tuple[torch.Tensor, torch.Tensor]]


def sn_blocks_apply(blocks: Sequence[SNBlock], x: torch.Tensor,
                    sharded: spatial.Layout = False) -> Tuple[torch.Tensor, SNState]:
    """A stack of SN blocks (JAX feature_extractor_apply, return_linear
    False); returns the output and each block's new (u, v)."""
    state = []
    for block in blocks:
        x, uv = block(x, sharded)
        state.append(uv)
    return x, state


def sn_convs(module: nn.Module) -> List[SNConv]:
    return [m for m in module.modules() if isinstance(m, SNConv)]


def assign_sn_state(module: nn.Module, state: SNState) -> None:
    """Keep new (u, v) pairs, in `sn_convs(module)` order."""
    convs = sn_convs(module)
    if len(convs) != len(state):
        raise ValueError(f"{len(state)} (u, v) pairs for {len(convs)} "
                         "spectral-norm convs")
    with torch.no_grad():
        for conv, (u, v) in zip(convs, state):
            conv.weight_u.copy_(u)
            conv.weight_v.copy_(v)


def cfg_compute_dtype(cfg) -> Optional[torch.dtype]:
    """The convolutions' dtype of cfg.compute_dtype: None for float32,
    torch.bfloat16 for bfloat16."""
    dtypes = {"float32": None, "bfloat16": torch.bfloat16}
    if cfg.compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: float32 or "
                         "bfloat16")
    return dtypes[cfg.compute_dtype]


def set_compute_dtype(module: nn.Module,
                      dtype: Optional[torch.dtype]) -> nn.Module:
    """Run every Conv and SNConv of `module` in `dtype` (None: the input's
    dtype)."""
    for m in module.modules():
        if isinstance(m, (Conv, SNConv)):
            m.compute_dtype = dtype
    return module


def init_weights_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """The JAX package's initialisation laws, drawn from `gen`: conv weights
    N(0, 0.02) and zero biases (ops/conv.py), BN gamma N(1, 0.02), beta 0,
    moving stats (0, 1) (ops/norm.py), unit-norm random SN vectors."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.02)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape,
                                                        generator=gen))
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, SNConv):
                m.weight_orig.copy_(torch.randn(m.weight_orig.shape,
                                                generator=gen) * 0.02)
                m.bias.zero_()
                for buf in (m.weight_u, m.weight_v):
                    v = torch.randn(buf.shape, generator=gen)
                    buf.copy_(v / v.norm().clamp_min(1e-12))
    return module
