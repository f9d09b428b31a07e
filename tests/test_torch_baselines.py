"""The port's SinGAN-style video baselines held against the JAX package on
the CPU, module by module: GeneratorCSG and GeneratorSG (reconstruction and
random mode, batch / per-sample / moving BatchNorm, the sampler),
WDiscriminatorBaselines, their converters, the baseline LR plan, the
baseline batch former, one D + G iteration and the calibration, and the
sampler's sub-batches at full width.

Weights are the JAX package's init (perturbed with numpy so that stages
differ and BatchNorm moving stats are not (0, 1)) and cross through
tools/convert.py. The JAX draws are reproduced from its key splits or
recorded by monkeypatching `hpvaegan_tpu.models.networks_3d.generate_noise`
and replayed to the port in call order (NDHWC there, NCDHW here).
Tolerances: rtol 1e-4 / atol 2e-5 per op (the discriminator) and for
gradients and state, losses rtol 1e-4 / atol 1e-7, atol 1e-4 for the
multi-stage generators (SG's un-normalised residual carry, as
tests/test_torch_parity.py:744-745).

The D + G iteration is held against the JAX steps with their BatchNorm's
batch statistics reduced in float64 (`float64_bn_statistics`): the JAX package
reduces them in float32 (ops/norm.py:42 there), and XLA's CPU reductions
then err by ~1e-5 of the values over a stage's ~7k voxels per channel. Most
of a baseline stage's input is zero padding at these tiny depths (6 of 8
frames), and the reconstruction's gradient amplifies that error: up to 1e-2
in the stage's first blocks' gradients, where the port's float32 gradients
equal its float64 ones within 1e-6. With float64 statistics the two
packages agree within 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu import evaluation as jeval
from hpvaegan_tpu import optim as joptim
from hpvaegan_tpu.models import blocks as jblocks
from hpvaegan_tpu.models import networks_3d as jnet
from hpvaegan_tpu.training import baselines_trainer as jbase
from hpvaegan_tpu.training import partition as jpart
from hpvaegan_tpu.training import steps as jsteps
from hpvaegan_tpu.training.state import ScaleTrainState as JState

from hpvaegan_tpu_torch import config as tcfg
from hpvaegan_tpu_torch import evaluation as teval
from hpvaegan_tpu_torch import models as tmodels
from hpvaegan_tpu_torch import optim as toptim
from hpvaegan_tpu_torch.data import video as tvideo
from hpvaegan_tpu_torch.models.blocks import assign_sn_state
from hpvaegan_tpu_torch.models.networks_3d import (GeneratorCSG, GeneratorSG,
                                                   WDiscriminatorBaselines)
from hpvaegan_tpu_torch.parallel import sampling as tsampling
from hpvaegan_tpu_torch.tools import step_parity
from hpvaegan_tpu_torch.tools.convert import (from_jax, from_jax_discriminator,
                                              to_jax, to_jax_discriminator)
from hpvaegan_tpu_torch.tools.step_parity import ReplayedNoise
from hpvaegan_tpu_torch.training import partition as tpart
from hpvaegan_tpu_torch.training import steps as tsteps
from hpvaegan_tpu_torch.training.state import ScaleTrainState
from hpvaegan_tpu_torch.utils import pyramid
from hpvaegan_tpu_torch.utils.noise import NoiseSource

from test_torch_trainer import LOSS_TOL, Recorder
from test_torch_training import OP_TOL, assert_trees_close, port_grads
from test_torch_video import (GEN_TOL, _cfgs, _ncdhw, _ndhwc, _perturb_tree,
                              _stage_thw)
from test_torch_video_training import _replay

torch.set_num_threads(1)

GENS = ["GeneratorCSG", "GeneratorSG"]
AMPS = np.asarray([1.0, 0.3, 0.2, 0.1, 0.05, 0.0], np.float32)
PORT = {"GeneratorCSG": GeneratorCSG, "GeneratorSG": GeneratorSG}
JAX = {"GeneratorCSG": (jnet.generator_csg_init, jnet.generator_csg_apply,
                        jnet.generator_csg_next_stage),
       "GeneratorSG": (jnet.generator_sg_init, jnet.generator_sg_apply,
                       jnet.generator_sg_next_stage)}


def _bcfgs(name, **kw):
    return _cfgs(generator=name, discriminator="WDiscriminatorBaselines",
                 **kw)


def _jax_init(cfg, name, n_stages, seed):
    """The JAX package's init of `name` grown to n_stages stages."""
    init, _, grow = JAX[name]
    params, state = init(cfg, jax.random.PRNGKey(seed))
    while len(params["body"]) < n_stages:
        params, state = grow(cfg, params, state)
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))


def _jax_generator(cfg, name, n_stages, seed):
    params, state = _jax_init(cfg, name, n_stages, seed)
    rng = np.random.RandomState(seed)
    return _perturb_tree(params, rng), _perturb_tree(state, rng)


def _port_generator(cfg, name, params, state, z_init=None):
    G = tmodels.get_generator(name, 3)(cfg)
    while len(G.body) < len(params["body"]):
        G.init_next_stage()
    G.load_state_dict(from_jax(params, state, ndim=3))
    if z_init is not None:
        G.z_init = _ncdhw(z_init)
    return G


def _jax_discriminator(cfg, seed):
    params, state = jnet.wdiscriminator_baselines_init(
        cfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    return _perturb_tree(params, rng), jax.tree_util.tree_map(np.asarray,
                                                              state)


def _stage_draws(cfg, name, key, batch, n_stages):
    """The JAX random mode's draws (networks_3d.py:412-420, 463-472 there):
    one split and one normal per stage idx = 1 .. n_stages - 1, at the
    stage's padded size, nfc channels for CSG and nc_im for SG."""
    pad, ch = ((cfg.num_layer + 1, cfg.nfc) if name == "GeneratorCSG"
               else (cfg.num_layer + 2, cfg.nc_im))
    out = []
    for idx in range(1, n_stages):
        key, sub = jax.random.split(key)
        t, h, w = _stage_thw(cfg, idx)
        out.append(np.asarray(jax.random.normal(
            sub, (batch, t + 2 * pad, h + 2 * pad, w + 2 * pad, ch))))
    return out


def _z(cfg, batch, seed):
    td0, h0, w0 = _stage_thw(cfg, 0)
    return np.random.RandomState(seed).randn(
        batch, td0, h0, w0, cfg.nc_im).astype(np.float32)


# ---------------------------------------------------------- registry ---

def test_registry_has_the_baselines():
    assert tmodels.get_generator("GeneratorCSG", 3) is GeneratorCSG
    assert tmodels.get_generator("GeneratorSG", 3) is GeneratorSG
    assert tmodels.get_discriminator("WDiscriminatorBaselines", 3) is \
        WDiscriminatorBaselines
    assert tmodels.BASELINES == ("GeneratorCSG", "GeneratorSG")
    for name in GENS:  # as in the JAX registry: 3D only
        with pytest.raises(NotImplementedError):
            tmodels.get_generator(name, 2)


# -------------------------------------------------------- converters ---

@pytest.mark.parametrize("name", GENS)
def test_baseline_generator_round_trip_is_bit_exact(name):
    """The JAX init tree (3 stages) -> the port's state_dict -> back, bit
    for bit and of the same structure; SG's stage tails have no bias; a 2D
    read is refused."""
    cj, ct = _bcfgs(name)
    params, state = _jax_init(cj, name, 3, seed=1)
    sd = from_jax(params, state, ndim=3)
    G = _port_generator(ct, name, params, state)
    assert len(G.body) == 3 and sorted(G.state_dict()) == sorted(sd)
    assert ("body.0.tail.weight" in sd) == (name == "GeneratorSG")
    assert "body.0.tail.bias" not in sd
    assert ("head.norm.running_var" in sd) == (name == "GeneratorCSG")
    p2, s2 = to_jax(G.state_dict(), ndim=3)
    for got, ref in ((p2, params), (s2, state)):
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(ref))
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, ref)
    with pytest.raises(ValueError, match="rank"):
        from_jax(params, state, ndim=2)
    with pytest.raises(ValueError, match="rank"):
        to_jax(G.state_dict(), ndim=2)


def test_wdiscriminator_baselines_round_trip_is_bit_exact():
    """netD: a plain conv head (no SN, no state), SN body, conv tail; bit
    for bit both ways; a 2D read is refused."""
    cj, ct = _bcfgs("GeneratorCSG")
    params, state = jnet.wdiscriminator_baselines_init(
        cj, jax.random.PRNGKey(2))
    params, state = (jax.tree_util.tree_map(np.asarray, t)
                     for t in (params, state))
    sd = from_jax_discriminator(params, state, ndim=3)
    assert sorted(k for k in sd if k.startswith("head.")) == [
        "head.conv.bias", "head.conv.weight"]
    D = WDiscriminatorBaselines(ct)
    D.load_state_dict(sd)
    p2, s2 = to_jax_discriminator(D.state_dict(), ndim=3)
    assert s2["head"] == {}
    for got, ref in ((p2, params), (s2, state)):
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(ref))
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, ref)
    with pytest.raises(ValueError, match="rank"):
        from_jax_discriminator(params, state, ndim=2)
    with pytest.raises(ValueError, match="rank"):
        to_jax_discriminator(D.state_dict(), ndim=2)


# ----------------------------------------------------- discriminator ---

def test_wdiscriminator_baselines_forward_and_sn_state_match_jax():
    """Scores at the input size padded by num_layer + 2, and the body's new
    (u, v); the forward writes no buffer."""
    cj, ct = _bcfgs("GeneratorCSG")
    params, state = _jax_discriminator(cj, seed=3)
    x = np.random.RandomState(4).uniform(
        -1, 1, (2, 3, 12, 17, 3)).astype(np.float32)
    y_j, new_state = jnet.wdiscriminator_baselines_apply(cj, params, state,
                                                         jnp.asarray(x))
    D = WDiscriminatorBaselines(ct)
    D.load_state_dict(from_jax_discriminator(params, state, ndim=3))
    before = {k: v.clone() for k, v in D.state_dict().items()}
    y_t, sn_state = D(_ncdhw(x))
    assert all(torch.equal(v, before[k]) for k, v in D.state_dict().items())
    p = cj.num_layer + 2
    assert y_t.shape == (2, 1, 3 + 2 * p, 12 + 2 * p, 17 + 2 * p)
    np.testing.assert_allclose(_ndhwc(y_t), np.asarray(y_j), **OP_TOL)
    assert len(sn_state) == cj.num_layer
    assign_sn_state(D, sn_state)
    assert_trees_close(to_jax_discriminator(D.state_dict(), ndim=3)[1],
                       new_state, **OP_TOL)


# -------------------------------------------------------- generators ---

@pytest.mark.parametrize("name", GENS)
@pytest.mark.parametrize("mode,bn", [("recon", "batch"), ("random", "batch"),
                                     ("random", "sample"),
                                     ("random", "moving")])
def test_baseline_generator_matches_jax(name, mode, bn):
    """3 stages at non-zero amps: reconstruction from Z_init broadcast to
    the batch (no draw), or random mode from z with the JAX draws (per
    sample in "sample" mode: the JAX sampler's vmap of batch-1 train-mode
    forwards, one key each); the output at scale 2, and in "batch" mode the
    BatchNorm statistics the forward folds."""
    cj, ct = _bcfgs(name)
    params, state = _jax_generator(cj, name, 3, seed=5)
    _, apply, _ = JAX[name]
    z_init, z = _z(cj, 1, 6), _z(cj, 2, 7)
    key = jax.random.PRNGKey(8)
    G = _port_generator(ct, name, params, state, z_init=z_init)
    kw = dict(amps=jnp.asarray(AMPS), train=bn != "moving")
    if mode == "recon":
        (x_j,), state_j = apply(cj, params, state,
                                noise_init=jnp.broadcast_to(z_init, z.shape),
                                key=key, is_random=False, **kw)
        noise = ReplayedNoise([], "cpu")
        x_t = G.reconstruct(_ncdhw(z), AMPS, noise, commit=True)[0]
    else:
        if bn == "sample":
            keys = jax.random.split(key, 2)
            x_j = jax.vmap(lambda zi, k: apply(
                cj, params, state, noise_init=zi[None], key=k,
                is_random=True, **kw)[0][0][0])(jnp.asarray(z), keys)
            draws = [np.concatenate(d) for d in zip(*[
                _stage_draws(cj, name, k, 1, 3) for k in keys])]
        else:
            (x_j,), state_j = apply(cj, params, state,
                                    noise_init=jnp.asarray(z), key=key,
                                    is_random=True, **kw)
            draws = _stage_draws(cj, name, key, 2, 3)
        noise = ReplayedNoise([_ncdhw(d) for d in draws], "cpu")
        with torch.no_grad():
            x_t = G(_ncdhw(z), AMPS, noise, bn=bn)[0]
    assert not noise.drawn
    assert x_t.shape == (2, 3) + tuple(_stage_thw(cj, 2))
    np.testing.assert_allclose(_ndhwc(x_t), np.asarray(x_j), **GEN_TOL)
    if bn == "batch":
        assert_trees_close(to_jax(G.state_dict(), ndim=3)[1], state_j,
                           **GEN_TOL)


@pytest.mark.parametrize("name", GENS)
@pytest.mark.parametrize("train", [True, False])
def test_generate_samples_of_a_baseline_matches_jax(name, train):
    """generate_samples(ndim=3) of netG_2 in both sampler modes: z of
    eval_z_tail (nc_im channels at scale 0's time depth, whatever cfg.td
    says), then the stages' draws."""
    cj, ct = _bcfgs(name, niter=1, num_samples=2)
    for c in (cj, ct):
        c.Noise_Amps = list(AMPS[:3])
        c.scale_idx = 2
        c.td = 3
    params, state = _jax_generator(cj, name, 3, seed=9)
    want = jeval.generate_samples(cj, params, state, ndim=3, seed=4,
                                  train_mode=train)
    _, ks = jax.random.split(jax.random.PRNGKey(4))
    kn, kf = jax.random.split(ks)
    z_tail = teval.eval_z_tail(ct, 3)
    assert z_tail == jeval.eval_z_tail(cj, 3) == (2, 12, 17, 3)
    draws = [np.asarray(jax.random.normal(kn, (2,) + z_tail))]
    if train:
        draws += [np.concatenate(d) for d in zip(*[
            _stage_draws(cj, name, k, 1, 3) for k in jax.random.split(kf, 2)])]
    else:
        draws += _stage_draws(cj, name, kf, 2, 3)
    noise = ReplayedNoise([_ncdhw(d) for d in draws], "cpu")
    got = teval.generate_samples(ct, _port_generator(ct, name, params, state),
                                 ndim=3, train_mode=train, noise=noise)
    assert not noise.drawn
    assert got.shape == (2,) + tuple(_stage_thw(cj, 2)) + (3,)
    np.testing.assert_allclose(got, np.asarray(want), **GEN_TOL)


@pytest.mark.parametrize("name", GENS)
def test_baseline_growth_copies_and_draws_nothing(name):
    _, ct = _bcfgs(name)
    G = PORT[name](ct)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    G.init_next_stage(gen)
    assert torch.equal(gen.get_state(), state)
    assert len(G.body) == 2 and G.body[1] is not G.body[0]
    for a, b in zip(G.body[0].state_dict().values(),
                    G.body[1].state_dict().values()):
        assert torch.equal(a, b)
    assert "z_init" not in G.state_dict()
    with pytest.raises(RuntimeError, match="z_init"):
        G.reconstruct(torch.zeros(1), AMPS, NoiseSource(0, "cpu"))


# ------------------------------------------------------------ LR plan ---

@pytest.mark.parametrize("name", GENS)
@pytest.mark.parametrize("train_depth", [1, 2])
@pytest.mark.parametrize("scale_idx", [0, 1, 2, 3])
def test_baseline_lr_plan_matches_jax(name, train_depth, scale_idx):
    """The plan of netG at scale_idx (scale_idx + 1 stages), including the
    head's cut-off at train_depth, and the subtrees apply_lr_plan trains."""
    cj, ct = _bcfgs(name, train_depth=train_depth)
    n = scale_idx + 1
    has = dict(has_head=name == "GeneratorCSG", has_tail=name == "GeneratorCSG")
    want = jpart.make_baseline_lr_plan(cj, scale_idx, n, **has)
    got = tpart.make_baseline_lr_plan(ct, scale_idx, n, **has)
    assert got == want
    G = PORT[name](ct)
    while len(G.body) < n:
        G.init_next_stage()
    groups = tpart.apply_lr_plan(G, got)
    trained = {id(p) for g in groups for p in g["params"]}
    for sub in [k for k in got if k != "body"]:
        assert all((id(p) in trained) == (got[sub] is not None)
                   for p in getattr(G, sub).parameters())
    for stage, lr in zip(G.body, got["body"]):
        assert all(p.requires_grad == (lr is not None)
                   for p in stage.parameters())
    assert {g["lr"] for g in groups} == {lr for lr in jax.tree_util.tree_leaves(
        want) if lr is not None}


# ------------------------------------------------------- batch former ---

def _inner_flip_key(batch):
    """A key whose inner former's flips take both branches (the JAX former
    splits (k_inner, k_noise), then k_inner as the video former does)."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        _, k_flip, _ = jax.random.split(jax.random.split(key)[0], 3)
        flips = np.asarray(jax.random.bernoulli(k_flip, 0.5,
                                                (batch, 1, 1, 1, 1)))
        if flips.any() and not flips.all():
            return key
    raise AssertionError("no key flips some samples and not others")


@pytest.mark.parametrize("hflip", [True, False])
def test_baseline_batch_former_matches_jax(hflip):
    """Starts, flips and windows as the video former, then only the
    (B, nc_im, td0, h0, w0) noise: the JAX former's latent noise, from its
    own subkey, is thrown away there and not drawn here (ReplayedNoise
    checks every shape)."""
    batch, scale = 4, 4
    cj, ct = _bcfgs("GeneratorCSG", batch_size=batch, hflip=hflip)
    td0, h0, w0 = _stage_thw(cj, 0)
    _, h, w = _stage_thw(cj, scale)
    rng = np.random.RandomState(0)
    frames = rng.rand(1, 5, h, w, 3).astype(np.float32)
    zero = rng.rand(1, 5, h0, w0, 3).astype(np.float32)
    key = _inner_flip_key(batch)
    k_inner, k_noise = jax.random.split(key)
    z_tail = (td0, h0, w0, 3)
    real_j, zero_j, noise_j = jbase.make_baseline_batch_body(
        cj, scale, z_tail)(jnp.asarray(frames), jnp.asarray(zero), key)
    k_start, k_flip, _ = jax.random.split(k_inner, 3)
    draws = [("randint", jax.random.randint(k_start, (batch,), 0, 5 - 2))]
    if hflip:
        draws.append(("bernoulli", jax.random.bernoulli(
            k_flip, 0.5, (batch, 1, 1, 1, 1))))
    draws.append(("normal", jax.random.normal(k_noise, (batch,) + z_tail)))
    noise = _replay(draws)
    real_t, zero_t, noise_t = tvideo.make_baseline_batch(
        ct, _ncdhw(frames), _ncdhw(zero), noise, scale_idx=scale)
    assert not noise.drawn
    assert noise_t.shape == (batch, 3, td0, h0, w0)
    np.testing.assert_allclose(_ndhwc(real_t), np.asarray(real_j), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(_ndhwc(zero_t), np.asarray(zero_j), rtol=0,
                               atol=2e-6)
    np.testing.assert_array_equal(_ndhwc(noise_t), np.asarray(noise_j))
    former = tsteps.batch_former(3, scale, baseline=True)
    assert former.func is tvideo.make_baseline_batch


# -------------------------------------------------------------- steps ---

@pytest.fixture
def jax_draws(monkeypatch):
    """Records every draw of the JAX 3D networks, in order (NDHWC)."""
    drawn = []
    orig = jnet.generate_noise

    def record(key, shape, kind="normal", dtype=jnp.float32):
        out = orig(key, shape, kind, dtype)
        drawn.append((kind, np.asarray(out)))
        return out

    monkeypatch.setattr(jnet, "generate_noise", record)
    return drawn


def _setup(name, scale_idx, seed=0):
    """The same baseline scale state in both packages: weights, Z_init,
    plan, plain Adam for G and D, and one batch of 2 clips."""
    cj, ct = _bcfgs(name)
    n = scale_idx + 1
    g_params, g_state = _jax_generator(cj, name, n, seed=seed)
    d_params, d_state = _jax_discriminator(cj, seed=seed + 7)
    z_init = _z(cj, 1, seed + 3)
    has = dict(has_head="head" in g_params, has_tail="tail" in g_params)
    plan = jpart.make_baseline_lr_plan(cj, scale_idx, n, **has)
    trainable = jpart.split_params(g_params, plan)[0]
    opt_g = Recorder(joptim.clipped_adam(jpart.lr_tree_for(trainable, plan),
                                         cj.beta1, grad_clip=float("inf")))
    opt_d = Recorder(joptim.adam(cj.lr_d, cj.beta1))
    jst = JState(g_params, g_state, d_params, d_state, opt_g.init(trainable),
                 opt_d.init(d_params), jax.random.PRNGKey(seed + 3))
    g_apply = jbase.make_baseline_g_apply(JAX[name][1], jnp.asarray(z_init))

    G = _port_generator(ct, name, g_params, g_state, z_init=z_init)
    D = WDiscriminatorBaselines(ct)
    D.load_state_dict(from_jax_discriminator(d_params, d_state, ndim=3))
    tst = ScaleTrainState(
        G, D, toptim.ClippedAdam(tpart.apply_lr_plan(
            G, tpart.make_baseline_lr_plan(ct, scale_idx, n, **has)),
            ct.beta1, grad_clip=float("inf")),
        toptim.adam(D.parameters(), ct.lr_d, ct.beta1), None)

    rng = np.random.RandomState(seed + 5)
    real = rng.uniform(-1, 1, (2,) + tuple(_stage_thw(cj, scale_idx)) + (3,))
    real_zero = rng.uniform(-1, 1, (2,) + tuple(_stage_thw(cj, 0)) + (3,))
    batch = (real.astype(np.float32), real_zero.astype(np.float32),
             _z(cj, 2, seed + 6))
    return cj, ct, plan, g_apply, (jst, opt_g, opt_d), tst, batch


def float64_batchnorm(orig):
    """The JAX package's train-mode BatchNorm `orig` with its batch
    statistics reduced in float64 (its formula otherwise, ops/norm.py:62-75
    there), returning float32."""
    def bn(params, state, x, train, momentum=0.9, eps=1e-5, groups=1):
        if not train or groups != 1:
            return orig(params, state, x, train, momentum, eps, groups)
        with jax.enable_x64(True):
            xf = x.astype(jnp.float64)
            axes = tuple(range(x.ndim - 1))
            mean, var = jnp.mean(xf, axes), jnp.var(xf, axes)
            new_state = {k: (momentum * state[k] + (1 - momentum) * v).astype(
                jnp.float32) for k, v in (("mean", mean), ("var", var))}
            inv = jax.lax.rsqrt(var + eps) * params["gamma"]
            y = ((xf - mean) * inv + params["beta"]).astype(x.dtype)
        return y, new_state

    return bn


@pytest.fixture
def float64_bn_statistics(monkeypatch):
    """float64_batchnorm in place of the JAX package's BatchNorm."""
    monkeypatch.setattr(jblocks, "batchnorm_apply",
                        float64_batchnorm(jblocks.batchnorm_apply))


def _metrics_match(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **LOSS_TOL)


@pytest.mark.parametrize("name,scale_idx", [("GeneratorCSG", 0),
                                            ("GeneratorCSG", 2),
                                            ("GeneratorSG", 1),
                                            ("GeneratorSG", 2)])
def test_baseline_iteration_matches_jax(jax_draws, float64_bn_statistics,
                                        name, scale_idx):
    """The D step (the fake in random mode, the real pass's SN state kept,
    the GP's double backward on the padded clips), then the G step
    (reconstruction from Z_init, then the fake, BatchNorm folded twice)
    against the updated D, as the JAX cores run them through
    make_baseline_g_apply: metrics, gradients of the trainable subtrees,
    BatchNorm and SN state. At scale 0 CSG's head trains too. The JAX
    generator reduces its BatchNorm statistics in float64 (module
    docstring)."""
    cj, ct, plan, g_apply, (jst, opt_g, opt_d), tst, batch = _setup(
        name, scale_idx)
    real, real_zero, noise_init = batch
    amps = jnp.asarray(AMPS)
    d_apply = jnet.wdiscriminator_baselines_apply

    d_core = jsteps._d_step_core(cj, g_apply, d_apply, opt_d, None)
    mid_j, md_j = d_core(jst, jnp.asarray(real), jnp.asarray(noise_init),
                         amps)
    assert [k for k, _ in jax_draws] == ["normal"] * scale_idx
    _, _, k_alpha = jax.random.split(jst.key, 3)
    draws = list(jax_draws) + [
        ("uniform", np.asarray(jax.random.uniform(k_alpha, ())))]
    tst.noise = _replay(draws)
    md_t = tsteps.d_step(ct, tst, _ncdhw(real), _ncdhw(noise_init),
                         list(AMPS))
    assert not tst.noise.drawn
    _metrics_match(md_t, md_j)
    assert_trees_close(port_grads(tst.D, lambda sd: to_jax_discriminator(
        sd, ndim=3)), opt_d.grads[0], **OP_TOL)
    assert_trees_close(to_jax_discriminator(tst.D.state_dict(), ndim=3)[1],
                       mid_j.d_state, **OP_TOL)

    jax_draws.clear()
    g_core = jsteps._g_step_core(cj, g_apply, d_apply, opt_g, plan,
                                 vae_phase=False, cd=None)
    new_j, mg_j = g_core(mid_j, jnp.asarray(real), jnp.asarray(real_zero),
                         jnp.asarray(noise_init), amps)
    assert [k for k, _ in jax_draws] == ["normal"] * scale_idx
    tst.noise = _replay(jax_draws)
    mg_t = tsteps.g_step(ct, tst, _ncdhw(real), _ncdhw(real_zero),
                         _ncdhw(noise_init), list(AMPS), vae_phase=False)
    assert not tst.noise.drawn
    _metrics_match(mg_t, mg_j)
    port = port_grads(tst.G, lambda sd: to_jax(sd, ndim=3))
    want = opt_g.grads[0]
    assert sorted(want["body"]) == [scale_idx]
    for sub in ("head", "tail"):
        assert (sub in want) == (plan.get(sub) is not None)
        if sub in want:
            assert_trees_close(port[sub], want[sub], **OP_TOL)
    assert_trees_close(port["body"][scale_idx], want["body"][scale_idx],
                       **OP_TOL)
    for pname, p in tst.G.named_parameters():
        assert (p.grad is not None) == p.requires_grad, pname
    assert_trees_close(to_jax(tst.G.state_dict(), ndim=3)[1], new_j.g_state,
                       **OP_TOL)


@pytest.mark.parametrize("name", GENS)
def test_baseline_calibration_matches_jax(name):
    """The RMSE of the reconstruction from Z_init; nothing drawn, no state
    kept."""
    cj, ct, _, g_apply, (jst, _, _), tst, batch = _setup(name, 2, seed=4)
    real, real_zero, _ = batch
    want = float(jsteps.make_calibration(cj, g_apply)(
        jst.g_params, jst.g_state, jnp.asarray(real), jnp.asarray(real_zero),
        jnp.asarray(AMPS), jax.random.PRNGKey(1)))
    before = {k: v.clone() for k, v in tst.G.state_dict().items()}
    got = tsteps.calibrate(tst.G, _ncdhw(real), _ncdhw(real_zero),
                           list(AMPS), ReplayedNoise([], "cpu"))
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    assert all(torch.equal(v, before[k])
               for k, v in tst.G.state_dict().items())


@pytest.mark.parametrize("name", GENS)
def test_step_parity_runs_a_baseline_iteration(name):
    """tools/step_parity's iteration of a baseline (what
    tests/test_torch_cuda.py::test_baseline_iteration_matches_cpu holds
    card against CPU): every scale a GAN scale, the
    baseline plan (scale 1: body[1] and the tail train), finite."""
    _, ct = _bcfgs(name, hflip=True, batch_size=2)
    out = step_parity.run_iteration(ct, 1, 0, "cpu", NoiseSource(0, "cpu"),
                                    3, name, "WDiscriminatorBaselines")
    assert "d_loss" in out["metrics"] and "g_loss" in out["metrics"]
    assert all(np.isfinite(v) for v in out["metrics"].values())
    g_grads = sorted(k for k in out["grads"] if k.startswith("G."))
    assert all(k.startswith(("G.body.1.", "G.tail.")) for k in g_grads)
    assert any(k.startswith("G.body.1.") for k in g_grads)
    assert any(k.startswith("D.head.") for k in out["grads"])


# ------------------------------------------------------------ sampler ---

def test_full_width_baseline_sample_runs_as_three_sub_batches():
    """At Config() widths on balloons_pan.avi's pyramid (13x192x257 at
    scale 9) a baseline's widest activation is 64 x 25 x 204 x 269 per
    sample, so 64 samples run as 21 / 21 / 22, each under 2^31 elements
    (GeneratorHPVAEGAN's stay 32 / 32). No forward runs."""
    cfg = tcfg.Config(video_path="balloons_pan.avi", max_frames=13,
                      sampling_rates=[4, 3, 2, 1],
                      generator="GeneratorCSG").finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm = 24.0, 0.75, 12
    cfg.scale_idx = cfg.stop_scale
    assert list(pyramid.scale_size_3d(
        9, cfg.scale_factor, cfg.stop_scale, cfg.img_size,
        cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps, cfg.fps_lcm,
        cfg.ar)) == [13, 192, 257]
    z_tail = teval.eval_z_tail(cfg, 3)
    for name in GENS:
        G = PORT[name](cfg)
        G.body.extend(G.body[0] for _ in range(cfg.stop_scale))
        per = tsampling.generator_elements(cfg, G, 3, z_tail)
        assert per == 64 * 25 * 204 * 269 == 87_801_600
        parts = tsampling.sub_batches(64, per)
        assert [b - a for a, b in parts] == [21, 21, 22]
        assert max(b - a for a, b in parts) * per < 2 ** 31
    hp = tmodels.get_generator("GeneratorHPVAEGAN", 3)(cfg)
    hp.body.extend(hp.decoder for _ in range(cfg.stop_scale))
    per = tsampling.generator_elements(cfg, hp, 3, (13, 24, 33, 128))
    assert per == 64 * 13 * 192 * 257
    assert tsampling.sub_batches(64, per) == [(0, 32), (32, 64)]
