"""The port's memory layout (ops/layout.py): 3D activations and weights
channels-last through every op between two convolutions, the same
iteration as in the NCDHW layout, and 2D untouched; the convolutions'
layout counters `conv.ndhwc` / `conv.ncdhw` (ops/conv.py)."""

import pytest
import torch

from hpvaegan_tpu_torch import models
from hpvaegan_tpu_torch.config import Config
from hpvaegan_tpu_torch.models.blocks import ConvBlock
from hpvaegan_tpu_torch.models.networks_3d import _zero_pad
from hpvaegan_tpu_torch.ops import conv as conv_mod
from hpvaegan_tpu_torch.ops import layout, norm
from hpvaegan_tpu_torch.ops.norm import batchnorm
from hpvaegan_tpu_torch.ops.resize import (resize_trilinear,
                                           resize_trilinear_padded,
                                           upscale_3d)
from hpvaegan_tpu_torch.tools.step_parity import build_state
from hpvaegan_tpu_torch.training import steps
from hpvaegan_tpu_torch.utils import profiling
from hpvaegan_tpu_torch.utils.noise import NoiseSource
from hpvaegan_tpu_torch.utils.pyramid import scale_size_2d

torch.set_num_threads(1)

CL = torch.channels_last_3d


def _cfg(ndim: int, generator: str = "GeneratorHPVAEGAN", batch: int = 2):
    kw = dict(nfc=8, num_layer=2, img_size=32, min_size=16, max_size=32,
              latent_dim=8, enc_blocks=1, vae_levels=2, scale_idx=3)
    if ndim == 3:
        kw.update(max_frames=5, sampling_rates=[2, 1], batch_size=batch)
    if generator in models.BASELINES:
        kw.update(generator=generator,
                  discriminator="WDiscriminatorBaselines")
    cfg = Config(**kw).finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm = 24.0, 0.75, 2
    return cfg


def _x(c: int = 4, shape=(3, 5, 6), batch: int = 2, grad=False):
    gen = torch.Generator().manual_seed(c + sum(shape))
    x = torch.randn((batch, c) + tuple(shape), generator=gen)
    return x.contiguous(memory_format=CL).requires_grad_(grad)


def _bn(mode, groups=1):
    def op():
        ones, zeros = torch.ones(4), torch.zeros(4)
        return batchnorm(_x(), ones * 1.1, zeros + 0.1, zeros, ones, mode,
                         groups=groups)[0]
    return op


def _conv(part):
    def op():
        x = _x(grad=True)
        w = layout.to_port(_x(4, (3, 3, 3), batch=8).detach()
                           ).requires_grad_(True)
        y = conv_mod.conv3d(x, w, padding=1)
        if part == "forward":
            return y
        y.backward(_x(8))
        return x.grad if part == "dgrad" else w.grad
    return op


def _upscale():
    cfg = _cfg(3)
    return upscale_3d(_x(3, (2, 6, 8)), 2, cfg.scale_factor, cfg.stop_scale,
                      cfg.img_size, cfg.stop_scale_time, cfg.sampling_rates,
                      cfg.org_fps, cfg.fps_lcm, cfg.ar)


OPS = {
    "conv3d_forward": _conv("forward"),
    "conv3d_dgrad": _conv("dgrad"),
    "conv3d_wgrad": _conv("wgrad"),
    "bn_batch": _bn("batch"),
    "bn_batch_groups2": _bn("batch", 2),
    "bn_batch_batch1": lambda: batchnorm(_x(batch=1), torch.ones(4),
                                         torch.zeros(4), torch.zeros(4),
                                         torch.ones(4), "batch")[0],
    "bn_moving": _bn("moving"),
    "bn_sample": _bn("sample"),
    "lrelu": lambda: conv_mod.lrelu(_x()),
    "resize_trilinear": lambda: resize_trilinear(_x(), (4, 7, 9)),
    "resize_trilinear_padded": lambda: resize_trilinear_padded(
        _x(), (4, 7, 9), 3, 5),
    "upscale_3d": _upscale,
    "zero_pad": lambda: _zero_pad(_x(), 3),
    "noise_add": lambda: _x() + NoiseSource(0, "cpu").normal((2, 4, 3, 5, 6)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_3d_op_keeps_channels_last(name):
    """Each op of the 3D path hands on a channels-last tensor from
    channels-last inputs (the noise add: a channels-last activation plus
    an NCDHW draw); the convolutions count as `conv.ndhwc`."""
    profiling.reset()
    profiling.enable(True)
    try:
        out = OPS[name]()
        counts = profiling.counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert out.ndim == 5 and layout.ndhwc(out), (out.shape, out.stride())
    assert "conv.ncdhw" not in counts
    assert counts.get("conv.ndhwc", 0) == {"conv3d_forward": 1,
                                           "conv3d_dgrad": 3,
                                           "conv3d_wgrad": 3}.get(name, 0)


@pytest.mark.parametrize("batch", [1, 2])
def test_row_reductions_equal_the_axis_reductions(batch):
    """The reductions by rows (ops/layout.py::rows, the card's BatchNorm
    statistics and the convolutions' bias gradient) equal those over the
    axes (0, 2, 3, 4) within float32 rounding, and the normalisation by
    rows is the same channels-last tensor."""
    x = _x(6, (3, 5, 7), batch=batch) * 2.0 + 0.5
    mean, var = norm._row_stats(x)
    assert torch.allclose(mean[0], x.mean((0, 2, 3, 4)), rtol=1e-5,
                          atol=1e-6)
    assert torch.allclose(var[0], x.var((0, 2, 3, 4), unbiased=False),
                          rtol=1e-5, atol=1e-6)
    assert torch.allclose(layout.channel_sum(x), x.sum((0, 2, 3, 4)),
                          rtol=1e-5, atol=1e-5)
    r = layout.rows(x)
    assert r.data_ptr() == x.data_ptr() and r.shape == (batch * 15, 42)
    gamma, beta = torch.rand(6) + 0.5, torch.randn(6)
    y = norm.normalize_batch(x, gamma, beta, mean, var)
    shape = (1, -1, 1, 1, 1)
    want = (x - mean.reshape(shape)) * (torch.rsqrt(var + 1e-5) * gamma
                                        ).reshape(shape) + beta.reshape(shape)
    assert layout.ndhwc(y) and torch.equal(y, want)


def _data(cfg, ndim: int):
    """The real image or clip at scale 3 and at scale 0, in [0, 1]."""
    gen = torch.Generator().manual_seed(1)
    frames = (cfg.max_frames,) if ndim == 3 else ()
    return [torch.rand((1, cfg.nc_im) + frames + tuple(scale_size_2d(
        k, cfg.scale_factor, cfg.stop_scale, cfg.img_size, cfg.ar)),
        generator=gen) for k in (3, 0)]


def _iteration(generator: str, batch: int = 2):
    """One D + G iteration of the tiny 3D configuration at scale 3 from
    seed 0: (metrics, each trained leaf's gradient as Adam took it and its
    step, the layout counters)."""
    cfg = _cfg(3, generator, batch)
    baseline = generator in models.BASELINES
    st = build_state(cfg, 3, 0, "cpu", 3, generator,
                     cfg.discriminator if baseline else "")
    st.noise = NoiseSource(0, "cpu")
    before = {f"{m}.{k}": p.detach().clone()
              for m in "GD" for k, p in getattr(st, m).named_parameters()}
    profiling.reset()
    profiling.enable(True)
    try:
        metrics = steps.train_iteration(
            cfg, st, *_data(cfg, 3), [1.0] + [0.05] * (cfg.stop_scale + 1),
            False, steps.batch_former(3, 3, baseline=baseline))
        counts = {k: v for k, v in profiling.counters().items()
                  if k in ("conv.ndhwc", "conv.ncdhw")}
    finally:
        profiling.enable(False)
        profiling.reset()
    leaves = {}
    for m in "GD":
        for k, p in getattr(st, m).named_parameters():
            if p.grad is not None:
                leaves[f"{m}.{k}"] = (p.grad.clone(),
                                      p.detach() - before[f"{m}.{k}"])
    # the conv biases in front of BatchNorm, whose gradient is 0 but for
    # rounding: Adam's step on it is noise of size lr
    bn_biases = {f"G.{k}.conv.bias" for k, m in st.G.named_modules()
                 if isinstance(m, ConvBlock)}
    return metrics, leaves, counts, bn_biases


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("generator", ["GeneratorHPVAEGAN", "GeneratorCSG"])
def test_3d_iteration_matches_the_ncdhw_layout(monkeypatch, generator,
                                               batch):
    """One D + G iteration of the tiny 3D HP-VAE-GAN and CSG in the port's
    layout gives the losses, gradients and Adam steps of the same
    iteration run in NCDHW (5-D tensors contiguous, ops/layout.py's
    FORMAT_5D switched) within float32 rounding; every 3D convolution
    then counts as `conv.ndhwc`, as many as the NCDHW run's count. Batch
    1 is the benchmark's, whose BatchNorm outputs once had a batch stride
    that cuDNN's weight gradient read as NCDHW."""
    got, got_leaves, got_counts, bn_biases = _iteration(generator, batch)
    monkeypatch.setattr(layout, "FORMAT_5D", torch.contiguous_format)
    want, want_leaves, want_counts, _ = _iteration(generator, batch)
    assert "conv.ncdhw" not in got_counts
    assert got_counts["conv.ndhwc"] == sum(want_counts.values()) > 50
    assert want_counts["conv.ncdhw"] > want_counts.get("conv.ndhwc", 0)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.allclose(got[k], want[k], rtol=1e-5, atol=1e-6), k
    assert sorted(got_leaves) == sorted(want_leaves)
    scale = max(float(g.norm()) for g, _ in want_leaves.values())
    for k, (grad, step) in got_leaves.items():
        want_grad, want_step = want_leaves[k]
        assert float((grad - want_grad).norm()) <= \
            1e-4 * float(want_grad.norm()) + 1e-7 * scale, k
        if k not in bn_biases:
            assert torch.allclose(step, want_step, rtol=1e-3, atol=1e-8), k


def test_2d_iteration_counts_no_3d_conv_and_stays_nchw(monkeypatch):
    """A 2D iteration counts neither `conv.ndhwc` nor `conv.ncdhw`, and
    every convolution's input and weight stays NCHW."""
    seen = []
    conv2d = conv_mod.conv2d

    def spy(x, weight, *args, **kw):
        seen.append(x.is_contiguous() and weight.is_contiguous())
        return conv2d(x, weight, *args, **kw)

    monkeypatch.setattr(conv_mod, "conv2d", spy)
    cfg = _cfg(2)
    st = build_state(cfg, 3, 0, "cpu", 2)
    st.noise = NoiseSource(0, "cpu")
    profiling.reset()
    profiling.enable(True)
    try:
        steps.train_iteration(cfg, st, *_data(cfg, 2),
                              [1.0] + [0.05] * (cfg.stop_scale + 1), False,
                              steps.batch_former(2, 3))
        counts = profiling.counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert len(seen) > 20 and all(seen)
    assert not {"conv.ndhwc", "conv.ncdhw"} & set(counts)
    assert counts["conv.wgrad2"] > 0


def test_an_ncdhw_state_loads_into_the_channels_last_modules(monkeypatch):
    """A scale state written while 3D weights were NCDHW (modules and
    optimizers built with FORMAT_5D switched) loads into channels-last
    ones: the same values, every 3D weight and Adam moment ODHWI."""
    from hpvaegan_tpu_torch.optim import load_optimizer_state

    cfg = _cfg(3)
    monkeypatch.setattr(layout, "FORMAT_5D", torch.contiguous_format)
    old = build_state(cfg, 3, 0, "cpu", 3)
    old.noise = NoiseSource(0, "cpu")
    steps.train_iteration(cfg, old, *_data(cfg, 3),
                          [1.0] + [0.05] * (cfg.stop_scale + 1), False,
                          steps.batch_former(3, 3))
    assert not any(layout.ndhwc(p) for p in old.G.parameters()
                   if p.ndim == 5)
    monkeypatch.undo()
    new = build_state(cfg, 3, 1, "cpu", 3)
    new.G.load_state_dict(old.G.state_dict())
    load_optimizer_state(new.opt_g, old.opt_g.state_dict())
    for (k, a), b in zip(old.G.state_dict().items(),
                         new.G.state_dict().values()):
        assert torch.equal(a, b), k
        assert b.ndim != 5 or layout.ndhwc(b), k
    moments = [v for s in new.opt_g.state.values() for v in s.values()
               if torch.is_tensor(v) and v.ndim == 5]
    assert moments and all(layout.ndhwc(v) for v in moments)
