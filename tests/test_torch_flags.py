"""The port's training flags held against the JAX package on the CPU:
--compute-dtype bfloat16 (per op and per iteration), --fused-dg, --paired-g
and --flat-opt.

The states, batches and draws are those of the plain steps' parity tests
(tests/test_torch_trainer.py, test_torch_video_training.py,
test_torch_baselines.py): the same weights in both packages, the JAX draws
recorded and replayed to the port in call order.

Tolerances:
  * bf16 per op: outputs bf16 in both packages, at most 1 bf16 ulp apart
    (a 64->64 conv: the float32 accumulations of XLA and oneDNN round to
    neighbouring bf16 values on ~1e-4 of the outputs; BatchNorm and the
    resize are bit-equal; the SN conv within one ulp of its output's
    scale), statistics float32 at OP_TOL. The 2D generator's bf16 forward
    is bit-equal to JAX's.
  * bf16 iteration, measured on these states: metrics rtol 1e-2 (largest
    5.2e-3, CSG), conv-weight gradients rtol 0.1 atol 3e-2 (largest
    excess 2.5e-2, 3D scale 3; 3e-3 in 2D), BatchNorm and SN state
    1e-3 (3.5e-4). The port must also be closer to JAX-bf16 than half the
    JAX-bf16 to JAX-f32 distance (0.01-0.37 of it measured, except G at 3D
    scale 3: see the test), which an f32 run would not be.
  * fused-dg, paired-g, flat-opt: float32, OP_TOL / LOSS_TOL as the plain
    steps (rtol 1e-4, atol 2e-5); the optimizers on identical gradients
    1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hpvaegan_tpu import optim as joptim
from hpvaegan_tpu.models import blocks as jblocks
from hpvaegan_tpu.models import networks_2d as jnet2
from hpvaegan_tpu.models import networks_3d as jnet3
from hpvaegan_tpu.ops import conv as jconv
from hpvaegan_tpu.ops import norm as jnorm
from hpvaegan_tpu.ops import resize as jresize
from hpvaegan_tpu.ops import spectral_norm as jsn
from hpvaegan_tpu.training import steps as jsteps

from hpvaegan_tpu_torch import optim as toptim
from hpvaegan_tpu_torch.models import get_generator
from hpvaegan_tpu_torch.models.blocks import (BatchNorm, SNConv,
                                              set_compute_dtype)
from hpvaegan_tpu_torch.models.networks_3d import (
    GeneratorHPVAEGAN as GeneratorHPVAEGAN3D)
from hpvaegan_tpu_torch.ops import conv as tconv
from hpvaegan_tpu_torch.ops import norm as tnorm
from hpvaegan_tpu_torch.ops import resize as tresize
from hpvaegan_tpu_torch.tools.convert import (_v_perm, to_jax,
                                              to_jax_discriminator)
from hpvaegan_tpu_torch.training import steps as tsteps
from hpvaegan_tpu_torch.utils.noise import NoiseSource

import test_torch_baselines as tb
import test_torch_trainer as t2
import test_torch_video_training as t3
from test_torch_baselines import float64_bn_statistics  # noqa: F401
from test_torch_trainer import LOSS_TOL, _clipped
from test_torch_training import (GEN_TOL, OP_TOL, assert_trees_close, cfgs,
                                 jax_generator, nchw, nhwc, port_generator,
                                 port_grads, replay)

torch.set_num_threads(1)

BF16_TOL = dict(rtol=0.1, atol=3e-2)
BF16_LOSS_TOL = dict(rtol=1e-2, atol=1e-6)
BF16_STATE_TOL = dict(rtol=1e-3, atol=1e-3)
AMPS = t2.AMPS


# ------------------------------------------------------------- helpers ---

def bf16_ulps(a, b) -> int:
    """The largest distance of two arrays of bf16 values, in bf16 ulps
    (their bit patterns on one ordered integer line)."""
    def ordered(x):
        bits = np.frombuffer(np.asarray(x, np.float32).tobytes(),
                             np.int32).astype(np.int64) >> 16
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return int(np.abs(ordered(a) - ordered(b)).max())


def to_channels_last(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def from_channels_last(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a, np.float32), -1, 1)))


class Variant:
    """One of the three step setups (2D, 3D, CSG) and what goes with it."""

    def __init__(self, kind, scale_idx, **kw):
        self.kind = kind
        if kind == "csg":
            (self.cj, self.ct, self.plan, self.g_apply,
             (self.jst, self.opt_g, self.opt_d), self.tst,
             self.batch) = tb._setup("GeneratorCSG", scale_idx, **kw)
            self.d_apply = jnet3.wdiscriminator_baselines_apply
            self.clip = float("inf")
        else:
            mod = t2 if kind == "2d" else t3
            (self.cj, self.ct, self.plan, (self.jst, self.opt_g, self.opt_d),
             self.tst, self.batch) = mod._setup(scale_idx, **kw)
            net = jnet2 if kind == "2d" else jnet3
            self.g_apply = net.generator_hpvaegan_apply
            self.d_apply = net.wdiscriminator2d_apply if kind == "2d" \
                else net.wdiscriminator3d_apply
            self.clip = self.ct.grad_clip
        self.ndim = 2 if kind == "2d" else 3
        self.jnet = jnet2 if kind == "2d" else jnet3

    def port_batch(self):
        return [from_channels_last(a) for a in self.batch]

    def jax_batch(self):
        return [jnp.asarray(a) for a in self.batch]

    def replay(self, draws):
        return replay(draws) if self.ndim == 2 else t3._replay(draws)

    def to_g(self, sd):
        return to_jax(sd, self.ndim)

    def to_d(self, sd):
        return to_jax_discriminator(sd, self.ndim)

    def g_pairs(self, jax_grads):
        """(port, JAX) leaves of G's trainable gradients, JAX's clipped as
        the port's ClippedAdam clips .grad in place."""
        port = port_grads(self.tst.G, self.to_g)
        want = _clipped(jax_grads, self.clip)
        out = []
        for name, tree in want.items():
            if name == "body":
                for i, sub in tree.items():
                    out += zip(jax.tree_util.tree_leaves(port["body"][i]),
                               jax.tree_util.tree_leaves(sub))
            else:
                out += zip(jax.tree_util.tree_leaves(port[name]),
                           jax.tree_util.tree_leaves(tree))
        return out

    def d_pairs(self, jax_grads):
        port = port_grads(self.tst.D, self.to_d)
        return list(zip(jax.tree_util.tree_leaves(port),
                        jax.tree_util.tree_leaves(jax_grads)))


@pytest.fixture
def record(monkeypatch):
    """record(module) -> the list every generate_noise of that JAX network
    module appends (kind, array) to."""
    def install(mod):
        drawn = []
        orig = mod.generate_noise

        def rec(key, shape, kind="normal", dtype=jnp.float32):
            out = orig(key, shape, kind, dtype)
            drawn.append((kind, np.asarray(out)))
            return out

        monkeypatch.setattr(mod, "generate_noise", rec)
        return drawn
    return install


def _metrics_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **tol)


def _pairs_close(pairs, **tol):
    for a, b in pairs:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# ------------------------------------------------------ bf16, per op ---

def _conv_weights(rng, ndim, cin, cout):
    w = (rng.randn(*((3,) * ndim), cin, cout) * 0.05).astype(np.float32)
    return w, (rng.randn(cout) * 0.1).astype(np.float32)


def _oi(w):
    """HWIO / DHWIO -> OIHW / OIDHW."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(w, (-1, -2), (0, 1))))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("op", ["conv", "sn_conv", "batchnorm", "resize"])
def test_bf16_ops_match_jax(op, ndim):
    """One op in bfloat16 in both packages: a 64->64 3x3(x3) conv with
    bias, an SN conv (power step and W / sigma in float32), train-mode
    BatchNorm (float32 statistics, bf16 output) and the align-corners
    resize: bf16 outputs within 1 bf16 ulp."""
    rng = np.random.RandomState(ndim)
    spatial = (12, 13) if ndim == 2 else (4, 9, 10)
    x = rng.randn(2, *spatial, 64).astype(np.float32)
    xt = from_channels_last(x)
    bf = jnp.bfloat16
    if op == "conv":
        w, b = _conv_weights(rng, ndim, 64, 64)
        fn = jconv.conv2d_apply if ndim == 2 else jconv.conv3d_apply
        want = fn({"w": w, "b": b}, jnp.asarray(x), padding=1,
                  compute_dtype=bf)
        got = tconv.conv(xt, _oi(w), torch.from_numpy(b), padding=1,
                         compute_dtype=torch.bfloat16)
    elif op == "sn_conv":
        w, b = _conv_weights(rng, ndim, 64, 64)
        u = rng.randn(64).astype(np.float32)
        v = rng.randn(64 * 3 ** ndim).astype(np.float32)
        u, v = u / np.linalg.norm(u), v / np.linalg.norm(v)
        want, st = jsn.sn_conv_apply({"w": w, "b": b}, {"u": u, "v": v},
                                     jnp.asarray(x), padding=1,
                                     compute_dtype=bf)
        conv = set_compute_dtype(SNConv(64, 64, 3, ndim), torch.bfloat16)
        with torch.no_grad():
            conv.weight_orig.copy_(_oi(w))
            conv.bias.copy_(torch.from_numpy(b))
        v_t = torch.empty(v.shape)
        v_t[torch.from_numpy(_v_perm(conv.weight_orig.shape))] = \
            torch.from_numpy(v)
        got, (u2, _) = conv(xt, torch.from_numpy(u), v_t)
        assert u2.dtype == torch.float32
        np.testing.assert_allclose(u2.numpy(), np.asarray(st["u"]), **OP_TOL)
    elif op == "batchnorm":
        xb = jnp.asarray(x).astype(bf)
        p = {"gamma": (1 + 0.1 * rng.randn(64)).astype(np.float32),
             "beta": (0.1 * rng.randn(64)).astype(np.float32)}
        s = {"mean": (0.1 * rng.randn(64)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 64).astype(np.float32)}
        want, st = jnorm.batchnorm_apply(p, s, xb, train=True)
        bn = BatchNorm(64)
        with torch.no_grad():
            for name, a in (("weight", p["gamma"]), ("bias", p["beta"]),
                            ("running_mean", s["mean"]),
                            ("running_var", s["var"])):
                getattr(bn, name).copy_(torch.from_numpy(a))
        got = bn(from_channels_last(xb.astype(jnp.float32)).bfloat16(),
                 "batch")
        assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(st["mean"]), **OP_TOL)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(st["var"]), **OP_TOL)
        _, b_var = tnorm.batch_stats(got)
        assert b_var.dtype == torch.float32
    else:
        xb = jnp.asarray(x).astype(bf)
        xtb = from_channels_last(xb.astype(jnp.float32)).bfloat16()
        if ndim == 2:
            want = jresize.resize_bilinear(xb, (17, 19))
            got = tresize.resize_bilinear(xtb, (17, 19))
        else:
            want = jresize.resize_trilinear(xb, (5, 17, 19))
            got = tresize.resize_trilinear(xtb, (5, 17, 19))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    got, want = to_channels_last(got), np.asarray(want.astype(jnp.float32))
    if op == "sn_conv":
        # W / sigma is float32 in both and equal to ~1e-7; where its bf16
        # rounding flips, an output moves by up to one bf16 ulp of the
        # output's largest magnitude
        assert np.abs(got - want).max() <= 2.0 ** (
            np.floor(np.log2(np.abs(want).max())) - 7)
    else:
        assert bf16_ulps(got, want) <= 1


def test_bf16_forward_flows_in_bf16_with_f32_latents():
    """Under bf16 a mid-chain activation (a BatchNorm input) is bf16, the
    encoder's mu / logvar and GeneratorVAE_nb's gate are float32, and the
    parameters and buffers stay float32 (tests/test_models.py:204-248 for
    the JAX package)."""
    for name in ("GeneratorHPVAEGAN", "GeneratorVAE_nb"):
        _, ct = cfgs(generator=name)
        G = get_generator(name, 2)(ct)
        for _ in range(2):
            G.init_next_stage(torch.Generator().manual_seed(0))
        set_compute_dtype(G, torch.bfloat16)
        seen = []
        G.body[1].block0.norm.register_forward_hook(
            lambda m, inp, out: seen.append((inp[0].dtype, out.dtype)))
        x = torch.rand(2, 3, 17, 17) * 2 - 1
        out = G.reconstruct(x, list(AMPS), NoiseSource(0, "cpu"))
        assert seen == [(torch.bfloat16, torch.bfloat16)]
        assert out[0].dtype == torch.bfloat16
        assert out[2].dtype == out[3].dtype == torch.float32
        if name == "GeneratorVAE_nb":
            (_, _, bern), _ = G.encode(x)
            assert bern.dtype == torch.float32
        assert all(t.dtype == torch.float32
                   for t in list(G.parameters()) + list(G.buffers()))
    G3 = GeneratorHPVAEGAN3D(t3._cfgs()[1])
    set_compute_dtype(G3, torch.bfloat16)
    (mu, logvar), _ = G3.encode(torch.rand(1, 3, 2, 12, 17))
    assert mu.dtype == logvar.dtype == torch.float32


# ------------------------------------------------- bf16, the iteration ---

@pytest.fixture
def f32_bn_reductions(monkeypatch):
    """The JAX package's train-mode bf16 BatchNorm with the same forward,
    bit for bit, whose gradient reductions over the broadcast statistics
    run in float32. XLA:CPU reduces a bf16 array in bf16 (a mean's
    gradient of 1/966 per element sums to 0.5, not 1.0), which PyTorch,
    cuDNN and XLA on accelerators do not: the port's gradients are held
    against these."""
    orig = jblocks.batchnorm_apply

    def bn(params, state, x, train, momentum=0.9, eps=1e-5, groups=1):
        if not train or groups != 1 or x.dtype != jnp.bfloat16:
            return orig(params, state, x, train, momentum, eps, groups)
        new_state = orig(params, state, x, train, momentum, eps)[1]
        xf = x.astype(jnp.float32)
        axes = tuple(range(x.ndim - 1))
        mean, var = jnp.mean(xf, axes), jnp.var(xf, axes)
        inv = jax.lax.rsqrt(var + eps) * params["gamma"]

        def op(fn, a, b):  # a bf16 op, computed in f32 and rounded
            return fn(a.astype(jnp.float32),
                      b.astype(x.dtype).astype(jnp.float32)).astype(x.dtype)
        y = op(jnp.add, op(jnp.multiply, op(jnp.subtract, x, mean), inv),
               params["beta"])
        return y, new_state

    monkeypatch.setattr(jblocks, "batchnorm_apply", bn)


def _jax_iteration(v, cd, vae_phase, record_to):
    """The JAX cores' iteration (D then G on a GAN scale) in `cd` from the
    variant's state: (metrics, D grads or None, G grads, new state, the
    D step's draws with alpha, the G step's draws)."""
    amps = jnp.asarray(AMPS)
    real, real_zero, noise_init = v.jax_batch()
    st, metrics, d_grads, d_draws = v.jst, {}, None, []
    if not vae_phase:
        d_core = jsteps._d_step_core(v.cj, v.g_apply, v.d_apply, v.opt_d, cd)
        st, metrics = d_core(st, real, noise_init, amps)
        d_grads = v.opt_d.grads[-1]
        _, _, k_alpha = jax.random.split(v.jst.key, 3)
        d_draws = list(record_to) + [
            ("uniform", np.asarray(jax.random.uniform(k_alpha, ())))]
        record_to.clear()
    g_core = jsteps._g_step_core(v.cj, v.g_apply, v.d_apply, v.opt_g, v.plan,
                                 vae_phase, cd)
    st, mg = g_core(st, real, real_zero, noise_init, amps)
    g_draws = list(record_to)
    record_to.clear()
    return ({**metrics, **mg}, d_grads, v.opt_g.grads[-1], st, d_draws,
            g_draws)


def _port_iteration(v, vae_phase, d_draws, g_draws):
    real, real_zero, noise_init = v.port_batch()
    metrics = {}
    if not vae_phase:
        v.tst.noise = v.replay(d_draws)
        metrics.update(tsteps.d_step(v.ct, v.tst, real, noise_init,
                                     list(AMPS)))
        assert not v.tst.noise.drawn
    v.tst.noise = v.replay(g_draws)
    metrics.update(tsteps.g_step(v.ct, v.tst, real, real_zero, noise_init,
                                 list(AMPS), vae_phase))
    assert not v.tst.noise.drawn
    return metrics


def _weights(pairs):
    """The conv weights' (port, JAX) pairs: bias and BatchNorm-affine
    gradients, sums over broadcasts, are reduced in bf16 by XLA:CPU
    outside BatchNorm too (see f32_bn_reductions) and are left out."""
    return [(np.asarray(a, np.float64), np.asarray(b, np.float64))
            for a, b in pairs if np.asarray(b).ndim > 1]


def _ratio(port, jbf, j32):
    """|port - JAX-bf16| / |JAX-bf16 - JAX-f32| over concatenated arrays."""
    flat = [np.concatenate([np.ravel(a) for a in xs])
            for xs in (port, jbf, j32)]
    return np.linalg.norm(flat[0] - flat[1]) / np.linalg.norm(
        flat[1] - flat[2])


@pytest.mark.parametrize("kind,scale_idx,held", [
    ("2d", 1, "GM"), ("2d", 3, "GDM"), ("3d", 1, "GM"), ("3d", 3, "D"),
    ("csg", 2, "GDM")])
def test_bf16_iteration_matches_jax_bf16(record, f32_bn_reductions, kind,
                                         scale_idx, held):
    """One iteration with --compute-dtype bfloat16 (a VAE-phase G step at
    scale 1; D then G at scales 2-3) against the JAX cores with
    cd=bfloat16: metrics, conv-weight gradients and G's BatchNorm and D's
    SN state within BF16_*_TOL; and, for the parts in `held` (G's and D's
    weight gradients, the metrics), closer to JAX-bf16 than half the
    JAX-bf16 to JAX-f32 distance. At 3D scale 3 G's gradients and the
    G step's metrics are not held to it: conv3d's float32 accumulation
    differs between oneDNN and XLA by one bf16 ulp on ~0.4% of the
    encoder's outputs, and the bf16 chain spreads that to the size of the
    bf16 / f32 gap (the forward itself is bit-equal at other weights,
    test_bf16_generator_forward_matches_jax_bit_for_bit)."""
    v = Variant(kind, scale_idx)
    drawn = record(v.jnet)
    vae_phase = kind != "csg" and v.cj.vae_levels >= scale_idx + 1
    m_bf, dg_bf, gg_bf, st_bf, d_draws, g_draws = _jax_iteration(
        v, jnp.bfloat16, vae_phase, drawn)
    m_32, dg_32, gg_32, _, _, _ = _jax_iteration(v, None, vae_phase, drawn)

    v.ct.compute_dtype = "bfloat16"
    for m in (v.tst.G, v.tst.D):
        set_compute_dtype(m, torch.bfloat16)
    m_t = _port_iteration(v, vae_phase, d_draws, g_draws)
    _metrics_close(m_t, m_bf, **BF16_LOSS_TOL)
    parts = {"G": (_weights(v.g_pairs(gg_bf)), _weights(v.g_pairs(gg_32)))}
    if dg_bf is not None:
        parts["D"] = (_weights(v.d_pairs(dg_bf)), _weights(v.d_pairs(dg_32)))
    for bf, _ in parts.values():
        _pairs_close(bf, **BF16_TOL)
    assert_trees_close(v.to_g(v.tst.G.state_dict())[1], st_bf.g_state,
                       **BF16_STATE_TOL)
    assert_trees_close(v.to_d(v.tst.D.state_dict())[1], st_bf.d_state,
                       **BF16_STATE_TOL)

    # the flow-through is there: JAX-f32 is farther from JAX-bf16 than
    # twice the port's distance to it
    for part in held:
        if part == "M":
            keys = sorted(m_bf)
            got = _ratio(*([[float(m[k]) for k in keys]]
                           for m in (m_t, m_bf, m_32)))
        else:
            bf, f32 = parts[part]
            got = _ratio([a for a, _ in bf], [b for _, b in bf],
                         [b for _, b in f32])
        assert got < 0.5, (part, got)


def test_bf16_generator_forward_matches_jax_bit_for_bit():
    """The 2D bf16 reconstruction (encoder, decoder, three stages) in both
    packages from the same weights and eps: bf16 outputs, bit-equal to
    JAX's, while JAX's f32 forward differs. (In 3D the same forward is
    bit-equal at some weights and not at others: a conv3d rounding flip,
    then BatchNorm's statistics over a few hundred voxels spread it; see
    test_bf16_iteration_matches_jax_bf16.)"""
    v = Variant("2d", 3, seed=1)
    real_zero = v.batch[1]
    key = jax.random.PRNGKey(11)
    outs = {}
    for cd in (jnp.bfloat16, None):
        (x, _, mu, _), _ = v.g_apply(v.cj, v.jst.g_params, v.jst.g_state,
                                     video=jnp.asarray(real_zero),
                                     amps=jnp.asarray(AMPS), key=key,
                                     is_random=False, train=True,
                                     compute_dtype=cd)
        outs[cd] = np.asarray(x.astype(jnp.float32))
    eps = np.asarray(jax.random.normal(jax.random.split(key)[0], mu.shape))
    G = set_compute_dtype(v.tst.G, torch.bfloat16)
    with torch.no_grad():
        got = G.reconstruct(from_channels_last(real_zero), list(AMPS),
                            v.replay([("normal", eps)]), commit=False)[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_channels_last(got), outs[jnp.bfloat16])
    assert np.abs(outs[jnp.bfloat16] - outs[None]).max() > 1e-3


# ------------------------------------------------------------ fused-dg ---

def _fused(v, record_to, n_fake):
    """The JAX fused iteration, and its draws in the port's order: the
    fake's n_fake normals (which the JAX G loss draws again from the same
    key), alpha, then eps when the generator has an encoder."""
    step = jsteps._fused_dg_step_core(v.cj, v.g_apply, v.d_apply, v.opt_g,
                                      v.opt_d, v.plan, None)
    new, metrics = step(v.jst, *v.jax_batch(), jnp.asarray(AMPS))
    drawn = list(record_to)
    fake, rest = drawn[:n_fake], drawn[n_fake:]
    eps = rest[:len(rest) - n_fake]
    for (_, a), (_, b) in zip(rest[len(eps):], fake):
        np.testing.assert_array_equal(a, b)
    _, _, k_alpha, _ = jax.random.split(v.jst.key, 4)
    alpha = [] if v.cj.bug_compat else [
        ("uniform", np.asarray(jax.random.uniform(k_alpha, ())))]
    return new, metrics, fake + alpha + eps


@pytest.mark.parametrize("kind,scale_idx,n_fake", [
    ("2d", 3, 3), ("3d", 3, 2), ("csg", 2, 2)])
def test_fused_dg_iteration_matches_jax(request, record, kind, scale_idx,
                                        n_fake):
    """--fused-dg: one GAN iteration against JAX `_fused_dg_step_core`:
    metrics, D's and G's gradients, G's BatchNorm state after the step
    (fold(fold(s, recon), fake)), D's (u, v) and weights. The CSG case
    reduces the JAX BatchNorm statistics in float64, as
    test_torch_baselines.py does."""
    if kind == "csg":
        request.getfixturevalue("float64_bn_statistics")
    v = Variant(kind, scale_idx)
    drawn = record(v.jnet)
    new_j, m_j, draws = _fused(v, drawn, n_fake)
    v.tst.noise = v.replay(draws)
    m_t = tsteps.fused_dg_iteration(v.ct, v.tst, *v.port_batch(),
                                    list(AMPS))
    assert not v.tst.noise.drawn
    _metrics_close(m_t, m_j, **LOSS_TOL)
    _pairs_close(v.d_pairs(v.opt_d.grads[0]), **OP_TOL)
    _pairs_close(v.g_pairs(v.opt_g.grads[0]), **OP_TOL)
    assert_trees_close(v.to_g(v.tst.G.state_dict())[1], new_j.g_state,
                       **OP_TOL)
    assert_trees_close(v.to_d(v.tst.D.state_dict())[1], new_j.d_state,
                       **OP_TOL)
    assert_trees_close(v.to_d(v.tst.D.state_dict())[0], new_j.d_params,
                       rtol=0, atol=1e-6)


def test_train_iteration_dispatches_fused_on_gan_scales_only(monkeypatch):
    """train_iteration runs the fused iteration on a GAN scale under
    cfg.fused_dg (before --paired-g) and the plain G step on a VAE
    scale."""
    calls = []
    monkeypatch.setattr(tsteps, "fused_dg_iteration",
                        lambda *a: calls.append("fused") or {})
    monkeypatch.setattr(tsteps, "d_step", lambda *a: calls.append("d") or {})
    monkeypatch.setattr(tsteps, "g_step", lambda *a: calls.append("g") or {})
    _, ct = cfgs(fused_dg=True, paired_g=True)
    batch = (torch.zeros(1), torch.zeros(1), torch.zeros(1))
    st = types.SimpleNamespace(noise=None)
    for vae_phase in (False, True):
        tsteps.train_iteration(ct, st, None, None, [], vae_phase,
                               former=lambda *a: batch)
    assert calls == ["fused", "g"]


# ------------------------------------------------------------ paired-g ---

def _pair_setup(scale_idx=3, seed=0):
    cj, ct = cfgs()
    params, state = jax_generator(cj, scale_idx, seed=seed)
    rng = np.random.RandomState(seed + 5)
    video = rng.uniform(-1, 1, (2, 17, 17, 3)).astype(np.float32)
    noise_init = rng.randn(2, 17, 17, cj.latent_dim).astype(np.float32)
    return cj, ct, params, state, video, noise_init


def test_paired_forward_matches_jax(record):
    """GeneratorHPVAEGAN.reconstruct_pair against JAX
    generator_hpvaegan_apply_pair from its draws (eps, then the refinement
    noise at the 2B shape): gen, fake, vae_out, mu, logvar, and the state
    (per-half BatchNorm folded recon first, the encoder's (u, v))."""
    cj, ct, params, state, video, noise_init = _pair_setup()
    drawn = record(jnet2)
    (gen, fake, vae, mu, logvar), new_state = \
        jnet2.generator_hpvaegan_apply_pair(
            cj, params, state, video=jnp.asarray(video),
            amps=jnp.asarray(AMPS), noise_init=jnp.asarray(noise_init),
            key=jax.random.PRNGKey(3), train=True)
    assert [a.shape[0] for _, a in drawn] == [2, 4, 4, 4]
    G = port_generator(ct, params, state)
    noise = replay(drawn)
    got = G.reconstruct_pair(nchw(video), nchw(noise_init), list(AMPS), noise)
    assert not noise.drawn
    for a, b in zip(got, (gen, fake, vae, mu, logvar)):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), **GEN_TOL)
    assert_trees_close(to_jax(G.state_dict())[1], new_state, **OP_TOL)


def test_paired_forward_equals_two_forwards():
    """With the refinement noise off (amps 0), the paired forward equals
    reconstruct() then forward() from the same eps, outputs and state
    (tests/test_models.py:125-175 for the JAX package)."""
    cj, ct, params, state, video, noise_init = _pair_setup()
    amps = [0.0] * len(AMPS)
    eps = np.random.RandomState(9).randn(2, 17, 17, cj.latent_dim)
    G1, G2 = (port_generator(ct, params, state) for _ in range(2))

    def stage_noise(b):
        """Zero refinement draws of batch b (amps 0: their values do not
        matter, their shapes are checked)."""
        out = []
        for k in range(1, 4):
            h, w = t2.scale_size_2d(k, ct.scale_factor, ct.stop_scale,
                                    ct.img_size, ct.ar)
            out.append(("normal", np.zeros((b, h, w, 3), np.float32)))
        return out

    gen, vae, mu, _ = G1.reconstruct(nchw(video), amps,
                                     replay([("normal", eps)]))
    fake = G1(nchw(noise_init), amps, replay(stage_noise(2)))[0]
    got = G2.reconstruct_pair(nchw(video), nchw(noise_init), amps,
                              replay([("normal", eps)] + stage_noise(4)))
    for a, b in zip(got[:4], (gen, fake, vae, mu)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
    for (k, a), b in zip(G2.state_dict().items(), G1.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("ndim", [2, 3])
def test_grouped_batchnorm_matches_jax_and_two_halves(ndim):
    """batchnorm(groups=2) against JAX batchnorm_apply(groups=2) and
    against two width-B applications folded in order."""
    rng = np.random.RandomState(ndim)
    spatial = (6, 7) if ndim == 2 else (3, 6, 7)
    a = rng.randn(3, 5, *spatial).astype(np.float32)
    b = (rng.randn(3, 5, *spatial) * 2 + 1).astype(np.float32)
    g, beta = (1 + 0.1 * rng.randn(5)).astype(np.float32), \
        (0.1 * rng.randn(5)).astype(np.float32)
    m0, v0 = (0.1 * rng.randn(5)).astype(np.float32), \
        rng.uniform(0.5, 1.5, 5).astype(np.float32)
    T = torch.from_numpy
    y, m, v = tnorm.batchnorm(T(np.concatenate([a, b])), T(g), T(beta), T(m0),
                              T(v0), "batch", groups=2)
    ya, m1, v1 = tnorm.batchnorm(T(a), T(g), T(beta), T(m0), T(v0), "batch")
    yb, m2, v2 = tnorm.batchnorm(T(b), T(g), T(beta), m1, v1, "batch")
    np.testing.assert_allclose(y.numpy(), torch.cat([ya, yb]).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), m2.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), v2.numpy(), rtol=1e-6, atol=1e-6)
    want, st = jnorm.batchnorm_apply(
        {"gamma": g, "beta": beta}, {"mean": m0, "var": v0},
        jnp.asarray(np.moveaxis(np.concatenate([a, b]), 1, -1)), train=True,
        groups=2)
    np.testing.assert_allclose(to_channels_last(y), np.asarray(want),
                               **OP_TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(st["mean"]), **OP_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(st["var"]), **OP_TOL)


def test_paired_g_step_matches_jax(record):
    """--paired-g: the GAN-phase G step against JAX `_g_step_core` with
    g_pair=generator_hpvaegan_apply_pair: metrics, gradients, state."""
    v = Variant("2d", 3)
    drawn = record(jnet2)
    core = jsteps._g_step_core(v.cj, v.g_apply, v.d_apply, v.opt_g, v.plan,
                               vae_phase=False, cd=None,
                               g_pair=jnet2.generator_hpvaegan_apply_pair)
    new_j, m_j = core(v.jst, *v.jax_batch(), jnp.asarray(AMPS))
    assert [a.shape[0] for _, a in drawn] == [2, 4, 4, 4]
    v.tst.noise = v.replay(drawn)
    v.ct.paired_g = True
    real, real_zero, noise_init = v.port_batch()
    m_t = tsteps.g_step(v.ct, v.tst, real, real_zero, noise_init, list(AMPS),
                        vae_phase=False)
    assert not v.tst.noise.drawn
    _metrics_close(m_t, m_j, **LOSS_TOL)
    _pairs_close(v.g_pairs(v.opt_g.grads[0]), **OP_TOL)
    assert_trees_close(v.to_g(v.tst.G.state_dict())[1], new_j.g_state,
                       **OP_TOL)


@pytest.mark.parametrize("generator,ndim", [("GeneratorVAE_nb", 2),
                                            ("GeneratorHPVAEGAN", 3),
                                            ("GeneratorCSG", 3)])
def test_paired_g_has_no_effect_without_a_pair(generator, ndim):
    """--paired-g changes nothing where the JAX package has no pair: the
    G step with it draws and computes what the step without it does."""
    from hpvaegan_tpu_torch.tools import step_parity

    if ndim == 2:
        ct = cfgs(generator=generator)[1]
    else:
        ct = tb._bcfgs(generator)[1] if generator == "GeneratorCSG" \
            else t3._cfgs()[1]
    assert getattr(get_generator(generator, ndim), "reconstruct_pair",
                   None) is None
    out = []
    for paired in (False, True):
        ct.paired_g = paired
        noise = step_parity.RecordingNoise(0, "cpu")
        out.append(step_parity.run_iteration(
            ct, 3, 0, "cpu", noise, ndim=ndim, generator=generator,
            discriminator="WDiscriminatorBaselines"
            if generator == "GeneratorCSG" else ""))
        out[-1]["draws"] = [tuple(t.shape) for t in noise.drawn]
    assert out[0]["draws"] == out[1]["draws"]
    assert out[0]["metrics"] == out[1]["metrics"]
    for part in ("grads", "state"):
        for k, a in out[0][part].items():
            np.testing.assert_array_equal(a, out[1][part][k])


# ------------------------------------------------------------ flat-opt ---

@pytest.mark.parametrize("kind", ["clipped_g", "plain_d"])
def test_flat_adam_matches_per_tensor_and_jax_flat_adam(kind):
    """3 steps on identical gradients (test_adam_matches_optax_on_identical_
    gradients' setup, tests/test_optim.py for the JAX package): FlatAdam
    equals ClippedAdam / Adam and JAX `flat_adam`; its state_dict
    round-trips into a fresh FlatAdam that continues the same."""
    rng = np.random.RandomState(0)
    shapes = {"a": (4, 3, 3, 3), "b": (5,), "c": (2, 6)}
    lrs = {"a": 5e-4, "b": 1e-4, "c": 5e-4}
    start = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * (40.0 if k != "c" else 0.1)
                  ).astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    beta1, clip = 0.5, 5.0

    if kind == "clipped_g":
        opt_j = joptim.clipped_adam(lrs, beta1, grad_clip=clip, flat=True)
    else:
        opt_j = joptim.adam(5e-4, beta1, flat=True)
    params_j = {k: jnp.asarray(v) for k, v in start.items()}
    st = opt_j.init(params_j)
    for g in grads:
        upd, st = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                               params_j)
        params_j = optax.apply_updates(params_j, upd)

    def build(flat):
        p = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in start.items()}
        if kind == "clipped_g":
            groups = [{"params": [p["a"], p["c"]], "lr": 5e-4},
                      {"params": [p["b"]], "lr": 1e-4}]
            opt = toptim.FlatAdam(groups, beta1, grad_clip=clip) if flat \
                else toptim.ClippedAdam(groups, beta1, grad_clip=clip)
        else:
            opt = toptim.FlatAdam(list(p.values()), beta1,
                                  grad_clip=float("inf"), lr=5e-4) if flat \
                else toptim.adam(list(p.values()), 5e-4, beta1)
        return p, opt

    def steps(p, opt, gs):
        for g in gs:
            for k, t in p.items():
                t.grad = torch.from_numpy(g[k].copy())
            opt.step()

    (pf, of), (pp, op) = build(True), build(False)
    steps(pf, of, grads[:2])
    steps(pp, op, grads)
    p2, o2 = build(True)
    with torch.no_grad():
        for k in p2:
            p2[k].copy_(pf[k])
    toptim.load_optimizer_state(o2, of.state_dict())
    steps(p2, o2, grads[2:])
    assert toptim.is_flat_state(o2.state_dict())
    assert not toptim.is_flat_state(op.state_dict())
    for k in shapes:
        got = p2[k].detach().numpy()
        np.testing.assert_allclose(got, pp[k].detach().numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(params_j[k]), rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="--flat-opt"):
        toptim.load_optimizer_state(op, of.state_dict())
    with pytest.raises(ValueError, match="--flat-opt"):
        toptim.load_optimizer_state(of, op.state_dict())
