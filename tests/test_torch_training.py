"""The port's training modules held against the JAX package on the CPU:
spectral norm, the discriminator, the encoder and reconstruction mode, the
losses (WGAN-GP double backward included), clipped Adam, the LR plan, and
the single-image data pipeline.

Weights are the JAX package's (perturbed with numpy where activations
would otherwise vanish) and cross through tools/convert.py. Every draw the
JAX package makes is replayed to the port, in call order, through
`tools/step_parity.py::ReplayedNoise`. Tolerances: rtol 1e-4, atol 2e-5
per op and for gradients and state (ROADMAP.md's per-op bar); atol 1e-4
for multi-scale generator outputs; 1e-6 for parameters after Adam steps on
identical gradients.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hpvaegan_tpu import config as jcfg
from hpvaegan_tpu import losses as jlosses
from hpvaegan_tpu import optim as joptim
from hpvaegan_tpu.data import image as jimage
from hpvaegan_tpu.models import networks_2d as jnet
from hpvaegan_tpu.ops import spectral_norm as jsn
from hpvaegan_tpu.training import partition as jpart

from hpvaegan_tpu_torch import config as tcfg
from hpvaegan_tpu_torch import losses as tlosses
from hpvaegan_tpu_torch import optim as toptim
from hpvaegan_tpu_torch.data import image as timage
from hpvaegan_tpu_torch.models import get_discriminator
from hpvaegan_tpu_torch.models.blocks import SNConv, assign_sn_state
from hpvaegan_tpu_torch.models.networks_2d import GeneratorHPVAEGAN
from hpvaegan_tpu_torch.ops.spectral_norm import spectral_normalize
from hpvaegan_tpu_torch.tools.convert import (_hwio_to_oihw, _v_perm,
                                              from_jax,
                                              from_jax_discriminator, to_jax,
                                              to_jax_discriminator)
from hpvaegan_tpu_torch.tools.step_parity import ReplayedNoise
from hpvaegan_tpu_torch.training import partition as tpart
from hpvaegan_tpu_torch.utils.noise import NoiseSource

torch.set_num_threads(1)

OP_TOL = dict(rtol=1e-4, atol=2e-5)
GEN_TOL = dict(rtol=0, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(REPO, "data", "imgs", "air_balloons.jpg")
CFG = dict(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
           min_size=16, max_size=32, vae_levels=2)  # 5 scales, 17 -> 33


def cfgs(**kw):
    j = jcfg.Config(**{**CFG, **kw}).finalize()
    t = tcfg.Config(**{**CFG, **kw}).finalize()
    return j, t


def nchw(a):
    """NHWC numpy -> NCHW torch (other ranks unchanged)."""
    a = np.asarray(a, np.float32)
    if a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def assert_trees_close(port, ref, **tol):
    """Two pytrees of the same structure, leaf by leaf."""
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                **tol), port, ref)


def replay(draws):
    """The port's ReplayedNoise over recorded JAX draws, in call order:
    ("normal", NHWC array, handed over NCHW), ("uniform", scalar) or
    ("bernoulli", bools)."""
    return ReplayedNoise([
        torch.from_numpy(np.asarray(a, bool).copy()) if kind == "bernoulli"
        else nchw(a) for kind, a in draws], "cpu")


def jax_generator(cfg, scale_idx, seed=0):
    """JAX init grown to `scale_idx` stages, every leaf but the SN vectors
    perturbed so that activations are O(1) and BN moving stats are not
    (0, 1)."""
    params, state = jnet.generator_hpvaegan_init(cfg, jax.random.PRNGKey(seed))
    for k in range(scale_idx):
        params, state = jnet.generator_init_next_stage(
            cfg, params, state, jax.random.PRNGKey(seed + 1 + k))
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = str(path[-1])
        if "var" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "mean" in name:
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if "'u'" in name or "'v'" in name:
            return a
        return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(perturb, params),
            jax.tree_util.tree_map_with_path(perturb, state))


def port_generator(cfg, params, state):
    gen = GeneratorHPVAEGAN(cfg)
    for _ in range(len(params["body"])):
        gen.init_next_stage()
    gen.load_state_dict(from_jax(params, state))
    return gen


def jax_discriminator(cfg, seed=0):
    p, s = jnet.wdiscriminator2d_init(cfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, (p, s))


def port_discriminator(cfg, params, state):
    D = get_discriminator(cfg.discriminator)(cfg)
    D.load_state_dict(from_jax_discriminator(params, state))
    return D


# ------------------------------------------------------- spectral norm ---

def test_spectral_normalize_matches_jax():
    """w / sigma, the new (u, v), and the gradient of an SN conv's output
    with respect to the weight through sigma."""
    rng = np.random.RandomState(0)
    w = rng.randn(3, 3, 5, 7).astype(np.float32) * 0.3  # HWIO
    b = rng.randn(7).astype(np.float32)
    u = rng.randn(7).astype(np.float32)
    v = rng.randn(45).astype(np.float32)
    u, v = u / np.linalg.norm(u), v / np.linalg.norm(v)
    x = rng.randn(2, 6, 9, 5).astype(np.float32)
    r = rng.randn(2, 6, 9, 7).astype(np.float32)

    w_bar, st = jsn.spectral_normalize(jnp.asarray(w), {"u": u, "v": v})

    def jloss(wj):
        out, _ = jsn.sn_conv_apply({"w": wj, "b": b}, {"u": u, "v": v},
                                   jnp.asarray(x), padding=1)
        return jnp.sum(out * r)

    g_jax = jax.grad(jloss)(jnp.asarray(w))

    w_t = torch.from_numpy(_hwio_to_oihw(w))
    v_t = torch.empty(45)
    v_t[torch.from_numpy(_v_perm(w_t.shape))] = torch.from_numpy(v)
    wb_t, u_new, v_new = spectral_normalize(w_t, torch.from_numpy(u), v_t)
    np.testing.assert_allclose(wb_t.numpy(), _hwio_to_oihw(w_bar), **OP_TOL)
    np.testing.assert_allclose(u_new.numpy(), np.asarray(st["u"]), **OP_TOL)
    np.testing.assert_allclose(v_new.numpy()[_v_perm(w_t.shape)],
                               np.asarray(st["v"]), **OP_TOL)

    conv = SNConv(5, 7, 3)
    with torch.no_grad():
        conv.weight_orig.copy_(w_t)
        conv.bias.copy_(torch.from_numpy(b))
    y, (u2, _) = conv(nchw(x), torch.from_numpy(u), v_t)
    (y * nchw(r)).sum().backward()
    np.testing.assert_allclose(conv.weight_orig.grad.numpy(),
                               _hwio_to_oihw(g_jax), **OP_TOL)
    assert torch.equal(u2, u_new)
    assert torch.equal(conv.weight_u, torch.zeros(7))  # buffers untouched


# ------------------------------------------------------- discriminator ---

def test_discriminator_forward_and_sn_state_match_jax():
    cj, ct = cfgs()
    params, state = jax_discriminator(cj, seed=1)
    x = np.random.RandomState(2).randn(2, 17, 21, 3).astype(np.float32)
    y_j, new_state = jnet.wdiscriminator2d_apply(cj, params, state,
                                                 jnp.asarray(x))
    D = port_discriminator(ct, params, state)
    before = {k: v.clone() for k, v in D.state_dict().items()}
    y_t, sn_state = D(nchw(x))
    assert all(torch.equal(v, before[k]) for k, v in D.state_dict().items())
    np.testing.assert_allclose(nhwc(y_t), np.asarray(y_j), **OP_TOL)
    assert y_t.shape == (2, 1, 17, 21)
    assign_sn_state(D, sn_state)
    assert_trees_close(to_jax_discriminator(D.state_dict())[1], new_state,
                       **OP_TOL)


def test_discriminator_checkpoint_round_trip():
    cj, _ = cfgs()
    params, state = jax_discriminator(cj, seed=3)
    p2, s2 = to_jax_discriminator(from_jax_discriminator(params, state))
    for a, b in ((p2, params), (s2, state)):
        assert (jax.tree_util.tree_structure(a)
                == jax.tree_util.tree_structure(b))
        jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)


# -------------------------------------------- encoder + reconstruction ---

@pytest.mark.parametrize("scale_idx", [1, 3])
def test_reconstruction_forward_and_state_match_jax(scale_idx):
    """train=True reconstruction with the JAX eps: outputs, mu, logvar, and
    the new BatchNorm and encoder SN state (commit=True); commit=False
    keeps every buffer. Scale 3 crosses the VAE boundary (vae_levels 2)."""
    cj, ct = cfgs()
    params, state = jax_generator(cj, scale_idx, seed=scale_idx)
    video = np.random.RandomState(5).uniform(-1, 1, (2, 17, 17, 3)).astype(
        np.float32)
    amps = np.asarray([1.0, 0.3, 0.2, 0.1, 0.05, 0.0], np.float32)
    key = jax.random.PRNGKey(11)
    (x_j, vae_j, mu_j, lv_j), new_state = jnet.generator_hpvaegan_apply(
        cj, params, state, video=jnp.asarray(video), amps=jnp.asarray(amps),
        key=key, is_random=False, train=True)
    kz, _ = jax.random.split(key)
    eps = np.asarray(jax.random.normal(kz, mu_j.shape))

    gen = port_generator(ct, params, state)
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    gen.reconstruct(nchw(video), amps, replay([("normal", eps)]),
                    commit=False)
    assert all(torch.equal(v, before[k]) for k, v in gen.state_dict().items())

    x_t, vae_t, mu_t, lv_t = gen.reconstruct(
        nchw(video), amps, replay([("normal", eps)]))
    for got, want in ((mu_t, mu_j), (lv_t, lv_j), (vae_t, vae_j),
                      (x_t, x_j)):
        np.testing.assert_allclose(nhwc(got), np.asarray(want), **GEN_TOL)
    assert_trees_close(to_jax(gen.state_dict())[1], new_state, **OP_TOL)


# -------------------------------------------------------------- losses ---

def _loss_inputs(seed=0):
    cj, ct = cfgs()
    params, state = jax_discriminator(cj, seed=seed)
    rng = np.random.RandomState(seed + 1)
    real = rng.uniform(-1, 1, (2, 13, 15, 3)).astype(np.float32)
    fake = rng.uniform(-1, 1, (2, 13, 15, 3)).astype(np.float32)
    return cj, ct, params, state, real, fake


def _d_fns(cj, ct, params, state):
    """JAX d(p)(x) and the port's D with its d(x)."""
    def jd(p):
        return lambda x: jnet.wdiscriminator2d_apply(cj, p, state, x)[0]
    D = port_discriminator(ct, params, state)
    return jd, D, (lambda x: D(x)[0])


def port_grads(module, to_jax_fn):
    """The module's .grad in the JAX params layout (None as zeros)."""
    sd = dict(module.state_dict())
    sd.update({k: torch.zeros_like(p) if p.grad is None else p.grad
               for k, p in module.named_parameters()})
    return to_jax_fn(sd)[0]


@pytest.mark.parametrize("which", ["gp", "d_loss"])
def test_d_losses_and_double_backward_match_jax(which):
    """The gradient penalty (per-channel norm, create_graph) and the full D
    loss: values, metrics, and the gradients with respect to D's weights
    through the double backward."""
    cj, ct, params, state, real, fake = _loss_inputs()
    jd, D, td = _d_fns(cj, ct, params, state)
    alpha = 0.37

    def jloss(p):
        if which == "gp":
            return jlosses.gradient_penalty(jd(p), jnp.asarray(real),
                                            jnp.asarray(fake), alpha,
                                            cj.lambda_grad), {}
        return jlosses.d_loss_fn(cj, jd(p), jnp.asarray(real),
                                 jnp.asarray(fake), alpha)

    (val_j, aux_j), g_j = jax.value_and_grad(jloss, has_aux=True)(params)
    if which == "gp":
        val_t, aux_t = tlosses.gradient_penalty(
            td, nchw(real), nchw(fake), torch.tensor(alpha),
            ct.lambda_grad), {}
    else:
        val_t, aux_t = tlosses.d_loss_fn(ct, td, nchw(real), nchw(fake),
                                         torch.tensor(alpha))
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=1e-4)
    for k in aux_j:
        np.testing.assert_allclose(aux_t[k].item(),
                                   float(aux_j[k]), rtol=1e-4, atol=1e-7)
    assert_trees_close(port_grads(D, to_jax_discriminator), g_j, **OP_TOL)


@pytest.mark.parametrize("bug_compat", [False, True])
def test_g_losses_match_jax(bug_compat):
    """Both G losses; the adversarial gradient reaches the fake unless
    bug_compat detaches it (reference losses.py:94)."""
    cj, ct, params, state, real, fake = _loss_inputs(seed=2)
    cj.bug_compat = ct.bug_compat = bug_compat
    jd, _, td = _d_fns(cj, ct, params, state)
    rng = np.random.RandomState(9)
    gen = rng.uniform(-1, 1, real.shape).astype(np.float32)
    gen_vae = rng.uniform(-1, 1, (2, 7, 8, 3)).astype(np.float32)
    real_zero = rng.uniform(-1, 1, (2, 7, 8, 3)).astype(np.float32)
    mu, logvar = rng.randn(2, 2, 7, 8, 4).astype(np.float32) * 0.5

    (tot_j, aux_j), (gg_j, gf_j) = jax.value_and_grad(
        lambda g, f: jlosses.g_gan_loss_fn(cj, jd(params), g,
                                           jnp.asarray(real), f),
        argnums=(0, 1), has_aux=True)(jnp.asarray(gen), jnp.asarray(fake))
    g_t = nchw(gen).requires_grad_(True)
    f_t = nchw(fake).requires_grad_(True)
    tot_t, aux_t = tlosses.g_gan_loss_fn(ct, td, g_t, nchw(real), f_t)
    tot_t.backward()
    np.testing.assert_allclose(tot_t.item(), float(tot_j), rtol=1e-4)
    for k in ("rec", "adv"):
        np.testing.assert_allclose(aux_t[k].item(), float(aux_j[k]),
                                   rtol=1e-4)
    np.testing.assert_allclose(nhwc(g_t.grad), np.asarray(gg_j), **OP_TOL)
    if bug_compat:
        assert f_t.grad is None or not f_t.grad.any()
        assert not np.asarray(gf_j).any()
    else:
        np.testing.assert_allclose(nhwc(f_t.grad), np.asarray(gf_j), **OP_TOL)

    vae_j, vaux_j = jlosses.g_vae_loss_fn(
        cj, jnp.asarray(gen), jnp.asarray(gen_vae), jnp.asarray(real),
        jnp.asarray(real_zero), jnp.asarray(mu.transpose(0, 2, 3, 1)),
        jnp.asarray(logvar.transpose(0, 2, 3, 1)))
    vae_t, vaux_t = tlosses.g_vae_loss_fn(
        ct, nchw(gen), nchw(gen_vae), nchw(real), nchw(real_zero),
        torch.from_numpy(mu), torch.from_numpy(logvar))
    np.testing.assert_allclose(vae_t.item(), float(vae_j), rtol=1e-4)
    for k in ("rec", "kl"):
        np.testing.assert_allclose(vaux_t[k].item(), float(vaux_j[k]),
                                   rtol=1e-4)


# ----------------------------------------------------------- optimizer ---

@pytest.mark.parametrize("kind", ["clipped_g", "plain_d"])
def test_adam_matches_optax_on_identical_gradients(kind):
    """3 steps from the same parameters on the same gradients. The G
    optimizer clips per tensor (two of the three tensors exceed the clip
    at every step) and has two learning rates; D's is plain Adam."""
    rng = np.random.RandomState(0)
    shapes = {"a": (4, 3, 3, 3), "b": (5,), "c": (2, 6)}
    lrs = {"a": 5e-4, "b": 1e-4, "c": 5e-4}
    start = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * (40.0 if k != "c" else 0.1)
                  ).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    beta1, clip = 0.5, 5.0

    if kind == "clipped_g":
        opt_j = joptim.clipped_adam(lrs, beta1, grad_clip=clip)
    else:
        opt_j = joptim.adam(5e-4, beta1)
    params_j = {k: jnp.asarray(v) for k, v in start.items()}
    st = opt_j.init(params_j)
    for g in grads:
        upd, st = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                               params_j)
        params_j = optax.apply_updates(params_j, upd)

    params_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in start.items()}
    if kind == "clipped_g":
        opt_t = toptim.ClippedAdam(
            [{"params": [params_t["a"], params_t["c"]], "lr": 5e-4},
             {"params": [params_t["b"]], "lr": 1e-4}], beta1, grad_clip=clip)
    else:
        opt_t = toptim.adam(list(params_t.values()), 5e-4, beta1)
    for g in grads:
        for k, p in params_t.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt_t.step()
    if kind == "clipped_g":
        norms = {k: np.linalg.norm(g) for k, g in grads[-1].items()}
        assert norms["a"] > clip and norms["b"] > clip and norms["c"] < clip
    for k in shapes:
        np.testing.assert_allclose(params_t[k].detach().numpy(),
                                   np.asarray(params_j[k]), rtol=0, atol=1e-6)


# ------------------------------------------------------------- LR plan ---

@pytest.mark.parametrize("train_all", [False, True])
@pytest.mark.parametrize("train_depth", [1, 3])
@pytest.mark.parametrize("vae_levels", [1, 3])
@pytest.mark.parametrize("scale_idx", [0, 1, 2, 3, 4, 6])
def test_lr_plan_matches_jax(scale_idx, vae_levels, train_depth, train_all):
    """The plan equals the JAX package's; apply_lr_plan freezes exactly the
    subtrees the plan leaves out and groups the rest by learning rate."""
    kw = dict(nfc=4, latent_dim=4, num_layer=1, enc_blocks=1,
              vae_levels=vae_levels, train_depth=train_depth,
              train_all=train_all)
    cj, ct = cfgs(**kw)
    plan = tpart.make_lr_plan(ct, scale_idx, scale_idx)
    assert plan == jpart.make_lr_plan(cj, scale_idx, scale_idx)

    gen = GeneratorHPVAEGAN(ct)
    for _ in range(scale_idx):
        gen.init_next_stage()
    groups = tpart.apply_lr_plan(gen, plan)
    subtrees = [(gen.encode, plan["encode"]), (gen.decoder, plan["decoder"])]
    subtrees += list(zip(gen.body, plan["body"]))
    in_groups = {id(p): g["lr"] for g in groups for p in g["params"]}
    assert len(in_groups) == sum(len(g["params"]) for g in groups)
    for module, lr in subtrees:
        for p in module.parameters():
            assert p.requires_grad == (lr is not None)
            assert in_groups.get(id(p)) == lr
    assert len(groups) == len({lr for _, lr in subtrees if lr is not None})


# ---------------------------------------------------------------- data ---

def test_load_image01_is_bit_equal_to_jax():
    got = timage.load_image01(IMAGE)
    want = jimage.load_image01(IMAGE)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (186, 248, 3)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        timage.load_image01(IMAGE + ".missing")


def test_scale_images_match_jax():
    cj, ct = cfgs(image_path=IMAGE)
    ds_j = jimage.SingleImageDataset(cj)
    ds_t = timage.SingleImageDataset(ct, "cpu")
    assert ct.ar == cj.ar == 186 / 248
    for k in range(ct.stop_scale + 1):
        got, want = ds_t.scale_image(k), ds_j.scale_image(k)
        assert ds_t.scale_size(k) == ds_j.scale_size(k)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0,
                                   atol=1e-6)
        assert ds_t.scale_image(k) is got  # cached


def test_batch_former_matches_jax():
    """B copies, each flipped on its own draw, [-1, 1], then noise_init."""
    cj, ct = cfgs(image_path=IMAGE, hflip=True, batch_size=4)
    ds_j = jimage.SingleImageDataset(cj)
    ds_t = timage.SingleImageDataset(ct, "cpu")
    for seed in range(10):  # a key whose flips take both branches
        kb = jax.random.PRNGKey(seed)
        k_flip, _ = jax.random.split(kb)
        flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (4, 1, 1, 1)))
        if 0 < flips.sum() < 4:
            break
    real_j, zero_j, init_j = jimage.make_image_batch_body(cj, 2)(
        ds_j.scale_image(2), ds_j.scale_image(0), kb)
    noise = replay([("bernoulli", flips.reshape(4)),
                         ("normal", np.asarray(init_j))])
    real_t, zero_t, init_t = timage.make_image_batch(
        ct, ds_t.scale_image(2), ds_t.scale_image(0), noise)
    np.testing.assert_allclose(nhwc(real_t), np.asarray(real_j), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(nhwc(zero_t), np.asarray(zero_j), rtol=0,
                               atol=2e-6)
    np.testing.assert_array_equal(nhwc(init_t), np.asarray(init_j))


def test_noise_source_training_draws():
    noise = NoiseSource(4, "cpu")
    a = noise.uniform()
    assert a.shape == () and 0 <= float(a) < 1
    flips = noise.bernoulli((64,))
    assert flips.dtype == torch.bool and 0 < int(flips.sum()) < 64
    again = NoiseSource(4, "cpu")
    assert torch.equal(again.uniform(), a)
