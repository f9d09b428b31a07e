"""The convolution's own autograd path (ops/conv.py: `_Conv`, whose input
gradient `_ConvInputGrad` takes its second derivative's weight part as an
ordinary weight gradient), held on the CPU to autograd's numerical
derivatives and to PyTorch's own convolution node; the convolutions the D
step's backward runs, and the G step's graph, which holds none of D's
parameters."""

import dataclasses

import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

from hpvaegan_tpu_torch.config import Config
from hpvaegan_tpu_torch.evaluation import generate_samples
from hpvaegan_tpu_torch.losses import gradient_penalty
from hpvaegan_tpu_torch.models import get_discriminator
from hpvaegan_tpu_torch.models.blocks import Conv, SNConv
from hpvaegan_tpu_torch.ops import conv as conv_mod
from hpvaegan_tpu_torch.tools.step_parity import build_state, he_init_
from hpvaegan_tpu_torch.training import steps
from hpvaegan_tpu_torch.training.steps import batch_former, d_step
from hpvaegan_tpu_torch.utils import profiling
from hpvaegan_tpu_torch.utils.noise import NoiseSource
from hpvaegan_tpu_torch.utils.pyramid import scale_size_2d

torch.set_num_threads(1)

KER = 3
K = (KER - 1) // 2


def _padding(kind: str, ndim: int):
    """k on every axis, 0, or the halo's tuple: 0 on H, k elsewhere."""
    if kind == "k":
        return K
    if kind == "0":
        return 0
    pads = [K] * ndim
    pads[-2] = 0
    return tuple(pads)


def _case(ndim, padding, stride, bias):
    gen = torch.Generator().manual_seed(ndim * 100 + stride)
    spatial = (5, 6) if ndim == 2 else (3, 5, 4)
    x = torch.randn((2, 2) + spatial, generator=gen, dtype=torch.float64)
    w = torch.randn((3, 2) + (KER,) * ndim, generator=gen,
                    dtype=torch.float64)
    b = torch.randn(3, generator=gen, dtype=torch.float64) if bias else None
    inputs = [t.requires_grad_(True) for t in (x, w, b) if t is not None]

    def fn(*args):
        x, w = args[:2]
        return conv_mod.conv(x, w, args[2] if bias else None, stride=stride,
                             padding=_padding(padding, ndim))
    return fn, inputs


CASES = pytest.mark.parametrize("ndim,padding,stride,bias", [
    (ndim, padding, stride, bias) for ndim in (2, 3)
    for padding in ("k", "0", "tuple") for stride in (1, 2)
    for bias in (True, False)])


@CASES
def test_conv_gradcheck(ndim, padding, stride, bias):
    fn, inputs = _case(ndim, padding, stride, bias)
    assert type(fn(*inputs).grad_fn).__name__ == "_ConvBackward"
    assert gradcheck(fn, inputs)


@CASES
def test_conv_gradgradcheck(ndim, padding, stride, bias):
    fn, inputs = _case(ndim, padding, stride, bias)
    assert gradgradcheck(fn, inputs)


class _Plain:
    """_Conv's stand-in: PyTorch's own convolution node."""

    @staticmethod
    def apply(x, weight, bias, stride, padding, fn):
        return fn(x, weight, bias, stride=stride, padding=padding)


def _cfg(ndim: int, **kw):
    kw = dict(dict(nfc=8, num_layer=2, img_size=32, min_size=16,
                   max_size=32, latent_dim=8, enc_blocks=1, vae_levels=2),
              **kw)
    if ndim == 3:
        kw.update(max_frames=5, sampling_rates=[2, 1], batch_size=2)
    cfg = Config(**kw).finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm = 24.0, 0.75, 2
    return cfg


def _critic_convs(D) -> int:
    return sum(isinstance(m, (Conv, SNConv)) for m in D.modules())


@pytest.mark.parametrize("ndim", [2, 3])
def test_gp_gradients_match_plain_path(monkeypatch, ndim):
    """The gradient penalty's gradients with respect to the critic's
    parameters, and its inner gradient, through `_Conv` equal those
    through PyTorch's own convolution node, in float64."""
    cfg = _cfg(ndim)
    D = get_discriminator(f"WDiscriminator{ndim}D", ndim)(cfg)
    he_init_(D, torch.Generator().manual_seed(ndim))
    D = D.double()
    gen = torch.Generator().manual_seed(7)
    shape = (2, cfg.nc_im) + (4,) * (ndim - 2) + (11, 13)
    real, fake = (torch.randn(shape, generator=gen, dtype=torch.float64)
                  for _ in "ab")
    params = list(D.parameters())

    def grads():
        gp = gradient_penalty(lambda x: D(x)[0], real, fake, 0.3, 10.0)
        return [gp] + list(torch.autograd.grad(gp, params,
                                               materialize_grads=True))

    got = grads()
    monkeypatch.setattr(conv_mod, "_Conv", _Plain)
    want = grads()
    assert len(got) == len(params) + 1
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-10), (a - b).abs().max()


def _data(cfg, ndim, scale, gen):
    frames = (cfg.max_frames,) if ndim == 3 else ()
    return torch.rand((1, cfg.nc_im) + frames + tuple(scale_size_2d(
        scale, cfg.scale_factor, cfg.stop_scale, cfg.img_size, cfg.ar)),
        generator=gen)


@pytest.mark.parametrize("ndim", [2, 3])
def test_d_step_backward_has_no_image_sized_filter(ndim):
    """A D step (the gradient penalty's double backward included) runs no
    convolution whose weight is larger than the kernel, and counts one
    second-order weight gradient (`conv.wgrad2`) per critic convolution:
    7 at the published num_layer 5."""
    cfg = dataclasses.replace(_cfg(ndim, num_layer=5), scale_idx=3)
    st = build_state(cfg, 3, 0, "cpu", ndim)
    st.noise = NoiseSource(0, "cpu")
    gen = torch.Generator().manual_seed(1)
    real, fake = _data(cfg, ndim, 3, gen), _data(cfg, ndim, 3, gen)
    profiling.reset()
    try:
        with torch.profiler.profile(record_shapes=True) as prof:
            d_step(cfg, st, real, None, None, fake=fake)
        wgrad2 = profiling.counters().get("conv.wgrad2")
    finally:
        profiling.reset()
    weights = [e.input_shapes[1] for e in prof.events()
               if e.name == "aten::convolution"]
    assert weights
    assert all(tuple(w[2:]) == (KER,) * ndim for w in weights), weights
    assert wgrad2 == _critic_convs(st.D) == 7


@pytest.mark.parametrize("ndim", [2, 3])
def test_no_grad_forward_makes_no_conv_call(monkeypatch, ndim):
    """The sampler, which runs under no_grad, calls plain `F.conv*` and
    never `_Conv`; a forward with grad on does."""
    calls, conv_fn = [], conv_mod._Conv

    class Spy:
        @staticmethod
        def apply(*args):
            calls.append(args[0].shape)
            return conv_fn.apply(*args)

    cfg = dataclasses.replace(_cfg(ndim), scale_idx=3, num_samples=2,
                              niter=1)
    cfg.Noise_Amps = [1.0] + [0.05] * (cfg.stop_scale + 1)
    st = build_state(cfg, 3, 0, "cpu", ndim)
    monkeypatch.setattr(conv_mod, "_Conv", Spy)
    out = generate_samples(cfg, st.G, ndim, noise=NoiseSource(1, "cpu"))
    assert out.shape[0] == 2 and not calls
    gen = torch.Generator().manual_seed(1)
    st.D(_data(cfg, ndim, 3, gen))
    assert len(calls) == _critic_convs(st.D)


def _leaves(loss: torch.Tensor) -> set:
    """The ids of the leaf tensors that loss's graph reaches."""
    seen, stack, out = set(), [loss.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if hasattr(fn, "variable"):
            out.add(id(fn.variable))
        stack.extend(n for n, _ in fn.next_functions)
    return out


@pytest.mark.parametrize("fused_dg", [False, True])
@pytest.mark.parametrize("ndim", [2, 3])
def test_g_step_graph_holds_no_critic_parameter(monkeypatch, ndim, fused_dg):
    """The G step's loss (after the D step of a GAN-scale iteration, or
    the fused iteration's) reaches G's parameters and none of D's, whose
    convolutions thus take no weight gradient there; D's parameters
    require grad again afterwards."""
    cfg = dataclasses.replace(_cfg(ndim, fused_dg=fused_dg), scale_idx=3)
    st = build_state(cfg, 3, 0, "cpu", ndim)
    st.noise = NoiseSource(0, "cpu")
    losses, g_update = [], steps._g_update

    def keep(st, loss, aux):
        losses.append(loss)
        return g_update(st, loss, aux)

    monkeypatch.setattr(steps, "_g_update", keep)
    gen = torch.Generator().manual_seed(1)
    steps.train_iteration(cfg, st, _data(cfg, ndim, 3, gen),
                          _data(cfg, ndim, 0, gen),
                          [1.0] + [0.5] * (cfg.stop_scale + 1), False,
                          batch_former(ndim, 3))
    reached = _leaves(losses[0])
    assert len(losses) == 1
    assert any(id(p) in reached for p in st.G.parameters())
    assert not any(id(p) in reached for p in st.D.parameters())
    assert all(p.requires_grad for p in st.D.parameters())
