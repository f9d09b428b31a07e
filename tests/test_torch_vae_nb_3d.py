"""The port's 3D GeneratorVAE_nb held against the JAX package on the CPU:
the encoder, the generator in both modes, the samplers (sub-batches and
on-device SVFID too), the converters and the serving module.
tests/test_torch_vae_nb_3d_training.py holds the training steps and the
CLIs.

The JAX package's own 3D GeneratorVAE_nb cannot run:
`generator_vae_nb_apply` (models/networks_3d.py:335-340 there) passes
`train_all_escape=False` to `refinement_layers_3d`, whose signature
(:214-217) has no such parameter, and raises TypeError
(test_the_jax_function_raises_without_the_shim). The `shim` fixture
replaces the module attribute `networks_3d.refinement_layers_3d`, for one
test, with a wrapper that takes the parameter and gives it its 2D meaning
(networks_2d.py:180-204 there: False makes the VAE-boundary stop_gradient
unconditional, even under --train-all): the original, called on a copy of
cfg whose train_all is False, as cfg.train_all is read only at the
boundary (:224). With train_all False, the default, that is the call
without the argument. No file of the JAX package changes:
`generator_vae_nb_apply` looks the name up in its module's globals when it
runs.

Weights are the JAX package's init of GeneratorVAE_nb (perturbed with
numpy) and cross through tools/convert.py. The JAX draws (the gate, the
refinement noise, eps and the Gumbel u) are recorded, or reproduced from
the sampler's key splits, and replayed to the port in call order; the gate
is (B, T, H, W, 1) there and (B, 1, T, H, W) here. Tolerances: rtol 1e-4 /
atol 2e-5 per op (the encoder, mu, logvar, the gate, gradients and
state; the bf16 gate within one bf16 ulp), atol 1e-4 for the multi-scale generator and sampler outputs, rtol
1e-3 for SVFIDs (sqrtm), the serving module atol 1e-4 and converted
weights bit for bit.
"""

import copy
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu import config as jcfg
from hpvaegan_tpu import evaluation as jeval
from hpvaegan_tpu.data import video as jvideo
from hpvaegan_tpu.export import stablehlo as jexport
from hpvaegan_tpu.models import networks_3d as jnet
from hpvaegan_tpu.parallel import sampling as jsampling
from hpvaegan_tpu.parallel.mesh import make_mesh
from hpvaegan_tpu.tools import convert as jconvert
from hpvaegan_tpu.tools import ms_ckpt as jms

from hpvaegan_tpu_torch import eval_video as teval_cli
from hpvaegan_tpu_torch import evaluation as teval
from hpvaegan_tpu_torch import models as tmodels
from hpvaegan_tpu_torch.export import serving
from hpvaegan_tpu_torch.models.blocks import (assign_sn_state,
                                              set_compute_dtype)
from hpvaegan_tpu_torch.models.networks_3d import (Encode3DVAE_nb,
                                                   GeneratorVAE_nb)
from hpvaegan_tpu_torch.parallel import sampling as tsampling
from hpvaegan_tpu_torch.tools import convert as tconvert
from hpvaegan_tpu_torch.tools import ms_ckpt as tms
from hpvaegan_tpu_torch.tools.step_parity import ReplayedNoise

import test_torch_video as s3
from test_torch_flags import bf16_ulps
from test_torch_training import assert_trees_close, port_grads
from test_torch_video_training import jax_draws  # noqa: F401 (a fixture)

torch.set_num_threads(1)

OP_TOL = dict(rtol=1e-4, atol=2e-5)
GEN_TOL = dict(rtol=0, atol=1e-4)
FID_TOL = dict(rtol=1e-3)
AMPS = np.asarray(s3.AMPS + [0.0], np.float32)
NB = dict(generator="GeneratorVAE_nb")


@pytest.fixture
def shim(monkeypatch):
    """networks_3d.refinement_layers_3d taking train_all_escape (module
    doc)."""
    orig = jnet.refinement_layers_3d

    def refinement_layers_3d(cfg, *args, train_all_escape=True, **kw):
        if not train_all_escape:
            cfg = copy.copy(cfg)
            cfg.train_all = False
        return orig(cfg, *args, **kw)

    monkeypatch.setattr(jnet, "refinement_layers_3d", refinement_layers_3d)


def cfgs(**kw):
    """Both packages' configs of the 3D GeneratorVAE_nb on synthetic.avi
    (5 scales, (T, H, W) (2, 12, 17) .. (3, 24, 33))."""
    return s3._cfgs(**NB, **kw)


def jax_nb(cfg, scale_idx, seed=0):
    """The JAX package's 3D GeneratorVAE_nb grown to `scale_idx` stages,
    every leaf but the SN vectors perturbed."""
    params, state = jnet.generator_vae_nb_init(cfg, jax.random.PRNGKey(seed))
    for k in range(scale_idx):
        params, state = jnet.generator_init_next_stage(
            cfg, params, state, jax.random.PRNGKey(seed + 1 + k))
    rng = np.random.RandomState(seed)
    return s3._perturb_tree(params, rng), s3._perturb_tree(state, rng)


def port_nb(ct, params, state):
    G = tmodels.get_generator("GeneratorVAE_nb", 3)(ct)
    for _ in range(len(params["body"])):
        G.init_next_stage()
    G.load_state_dict(tconvert.from_jax(params, state, ndim=3))
    return G


def replay(draws):
    """ReplayedNoise over JAX draws in call order: 5-D arrays (the gate as
    bools) handed over NCDHW, scalars as they are."""
    def one(kind, a):
        a = np.asarray(a, np.float32)
        t = s3._ncdhw(a) if a.ndim == 5 else torch.from_numpy(a)
        return t.bool() if kind == "bernoulli" else t
    return ReplayedNoise([one(k, a) for k, a in draws], "cpu")


def to_jax3(sd):
    return tconvert.to_jax(sd, ndim=3)


def thw(cfg, idx):
    return tuple(s3._stage_thw(cfg, idx))


def test_the_jax_function_raises_without_the_shim():
    """The reference's fault stands: unshimmed, the JAX package's 3D
    GeneratorVAE_nb raises TypeError in both modes."""
    cj, _ = cfgs()
    params, state = jax_nb(cj, 1)
    td0, h0, w0 = thw(cj, 0)
    z = jnp.zeros((1, td0, h0, w0, cj.latent_dim))
    with pytest.raises(TypeError, match="train_all_escape"):
        jnet.generator_vae_nb_apply(cj, params, state, amps=jnp.asarray(AMPS),
                                    noise_init=z, key=jax.random.PRNGKey(0),
                                    is_random=True, train=True)
    with pytest.raises(TypeError, match="train_all_escape"):
        jnet.generator_vae_nb_apply(cj, params, state,
                                    video=jnp.zeros((1, td0, h0, w0, 3)),
                                    amps=jnp.asarray(AMPS),
                                    key=jax.random.PRNGKey(0), train=True)


@pytest.fixture
def f32_logistic(monkeypatch):
    """jax.nn.sigmoid of a bf16 array computed in float32 and rounded once,
    as PyTorch and the accelerators compute it. XLA:CPU expands a bf16
    logistic into 1 / (1 + exp(-x)) with every step rounded to bf16, up to
    2 bf16 ulps off the rounded value on a third of the outputs; the port's
    gate is held against the rounded value."""
    orig = jax.nn.sigmoid
    monkeypatch.setattr(jax.nn, "sigmoid", lambda x: orig(
        x.astype(jnp.float32)).astype(x.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(request, dtype):
    """Encode3DVAE_nb: (mu, logvar) averaged over (T, H, W), the gate
    (B, 1, T, H, W), all float32 also under bf16, and the SN blocks' new
    (u, v). Under bf16 the JAX gate's logistic is rounded once
    (f32_logistic), and the gate, a sigmoid of a bf16 convolution, is held
    within one bf16 ulp as test_torch_flags.py holds a bf16 convolution:
    XLA's and oneDNN's float32 accumulations may round to neighbouring
    bf16 values."""
    bf16 = dtype == "bfloat16"
    if bf16:
        request.getfixturevalue("f32_logistic")
    cj, ct = cfgs()
    params, state = jax_nb(cj, 0, seed=1)
    G = port_nb(ct, params, state)
    assert isinstance(G.encode, Encode3DVAE_nb)
    td0, h0, w0 = thw(cj, 0)
    x = np.random.RandomState(3).uniform(-1, 1, (2, td0, h0, w0, 3)).astype(
        np.float32)
    cd = jnp.bfloat16 if bf16 else None
    (mu_j, lv_j, bern_j), enc_s = jnet.encode3dvae_nb_apply(
        cj, params["encode"], state["encode"], jnp.asarray(x),
        compute_dtype=cd)
    if bf16:
        set_compute_dtype(G.encode, torch.bfloat16)
    with torch.no_grad():
        (mu_t, lv_t, bern_t), sn = G.encode(s3._ncdhw(x))
    assert mu_t.shape == (2, 8, 1, 1, 1) and bern_t.shape == (2, 1, td0, h0,
                                                              w0)
    for got, want in ((mu_t, mu_j), (lv_t, lv_j), (bern_t, bern_j)):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        if bf16 and got is bern_t:
            assert bf16_ulps(s3._ndhwc(got), np.asarray(want)) <= 1
        else:
            np.testing.assert_allclose(s3._ndhwc(got), np.asarray(want),
                                       **OP_TOL)
    assign_sn_state(G.encode, sn)
    assert_trees_close(to_jax3(G.state_dict())[1]["encode"], enc_s, **OP_TOL)


@pytest.mark.parametrize("train_all", [False, True])
@pytest.mark.parametrize("bn", ["batch", "moving"])
def test_random_forward_matches_jax(shim, jax_draws, bn, train_all):
    """Batch statistics (train) and moving statistics: the gate (B, 1, td0,
    h0, w0) first, then refinement noise at EVERY stage (stage 1 too, below
    vae_levels, unlike GeneratorHPVAEGAN 3D); the state the forward
    folds."""
    cj, ct = cfgs(train_all=train_all)
    params, state = jax_nb(cj, cj.stop_scale, seed=1)
    td0, h0, w0 = thw(cj, 0)
    z = np.random.RandomState(2).randn(2, td0, h0, w0, 8).astype(np.float32)
    (x_j, vae_j, mu, _, bern), new_state = jnet.generator_vae_nb_apply(
        cj, params, state, amps=jnp.asarray(AMPS), noise_init=jnp.asarray(z),
        key=jax.random.PRNGKey(7), is_random=True, train=bn == "batch")
    assert mu is None and bern is None
    assert [k for k, _ in jax_draws] == ["bernoulli"] + ["normal"] * 4
    assert jax_draws[0][1].shape == (2, td0, h0, w0, 1)
    G = port_nb(ct, params, state)
    noise = replay(jax_draws)
    with torch.no_grad():
        x_t, vae_t = G(s3._ncdhw(z), AMPS, noise, bn=bn)
    assert not noise.drawn
    assert x_t.shape == (2, 3) + thw(cj, cj.stop_scale)
    np.testing.assert_allclose(s3._ndhwc(vae_t), np.asarray(vae_j), **GEN_TOL)
    np.testing.assert_allclose(s3._ndhwc(x_t), np.asarray(x_j), **GEN_TOL)
    assert_trees_close(to_jax3(G.state_dict())[1], new_state, **GEN_TOL)


@pytest.mark.parametrize("train_all", [False, True])
def test_reconstruction_and_gradients_match_jax(shim, jax_draws, train_all):
    """Reconstruction at scale 3 (the VAE boundary before stage 1): eps
    (mu's shape) then u (the gate's); the outputs, mu, logvar, the gate,
    the folded state, and the gradients of mean(x^2) + mean(vae_out^2):
    stage 0's are zero in both, train_all or not (the detach is
    unconditional), the decoder's are not."""
    cj, ct = cfgs(train_all=train_all)
    params, state = jax_nb(cj, 3, seed=3)
    td0, h0, w0 = thw(cj, 0)
    video = np.random.RandomState(4).uniform(
        -1, 1, (2, td0, h0, w0, 3)).astype(np.float32)

    def loss(p):
        out, ns = jnet.generator_vae_nb_apply(
            cj, p, state, video=jnp.asarray(video), amps=jnp.asarray(AMPS),
            key=jax.random.PRNGKey(8), train=True)
        return jnp.mean(out[0] ** 2) + jnp.mean(out[1] ** 2), (out, ns)

    (_, (want, new_state)), grads_j = jax.value_and_grad(
        loss, has_aux=True)(params)
    assert [k for k, _ in jax_draws] == ["normal", "uniform"]
    assert jax_draws[0][1].shape == (2, 1, 1, 1, 8)
    assert jax_draws[1][1].shape == (2, td0, h0, w0, 1)

    G = port_nb(ct, params, state)
    with torch.no_grad():
        bern_t = G.encode(s3._ncdhw(video))[0][2]
    noise = replay(jax_draws)
    out = G.reconstruct(s3._ncdhw(video), AMPS, noise)
    assert len(out) == 4 and not noise.drawn
    ((out[0] ** 2).mean() + (out[1] ** 2).mean()).backward()
    for got, ref in zip(out + (bern_t,), want):
        np.testing.assert_allclose(s3._ndhwc(got), np.asarray(ref),
                                   **GEN_TOL)
    assert_trees_close(to_jax3(G.state_dict())[1], new_state, **OP_TOL)
    got_grads = port_grads(G, to_jax3)
    assert_trees_close(got_grads, grads_j, **OP_TOL)
    for tree in (got_grads, grads_j):
        assert not any(np.any(np.asarray(g)) for g in
                       jax.tree_util.tree_leaves(tree["body"][0]))
        assert any(np.any(np.asarray(g)) for g in
                   jax.tree_util.tree_leaves(tree["decoder"]))


# ------------------------------------------------------------ samplers ---

def sampler_draws(cfg, key, batch, train):
    """Every draw of the JAX sharded_sampler(ndim=3) of GeneratorVAE_nb
    (parallel/sampling.py:66-86, networks_3d.py:300-321 there): z at the
    eval time depth from kn; then, per sample from its vmapped key (train)
    or batched from kf (moving statistics), the key splits into (kz, kb,
    kr): the gate Bernoulli(0.5) of z's shape with one channel from kb, and
    kr split once per stage, at every stage. As the port draws them: z,
    the gate, the stages."""
    kn, kf = jax.random.split(key)
    z_tail = teval.eval_z_tail(cfg, 3)
    z = np.asarray(jax.random.normal(kn, (batch,) + z_tail))

    def one(k, b):
        _, kb, kr = jax.random.split(k, 3)
        out = [np.asarray(jax.random.bernoulli(
            kb, 0.5, (b,) + z_tail[:-1] + (1,)), np.float32)]
        for idx in range(cfg.stop_scale):
            kr, sub = jax.random.split(kr)
            out.append(np.asarray(jax.random.normal(
                sub, (b,) + thw(cfg, idx + 1) + (3,))))
        return out

    if train:
        per = [one(k, 1) for k in jax.random.split(kf, batch)]
        rest = [np.concatenate(s) for s in zip(*per)]
    else:
        rest = one(kf, batch)
    return [("normal", z), ("bernoulli", rest[0])] + \
        [("normal", a) for a in rest[1:]]


def split_draws(draws, parts):
    """The draws of a sampler run in sub-batches `parts`: z whole, then per
    sub-batch its rows of the gate and of every stage's noise."""
    out = draws[:1]
    for a, b in parts:
        out += [(kind, arr[a:b]) for kind, arr in draws[1:]]
    return out


def sampler_cfgs(seed=0, **kw):
    cj, ct = cfgs(niter=1, **kw)
    for c in (cj, ct):
        c.Noise_Amps = s3.AMPS
        c.scale_idx = c.stop_scale
        c.td = thw(c, c.stop_scale)[0]
    return cj, ct, jax_nb(cj, cj.stop_scale, seed=seed)


@pytest.mark.parametrize("train", [True, False])
def test_generate_samples_matches_jax(shim, monkeypatch, train):
    """generate_samples(ndim=3) in both sampler modes, z and the gate at
    the eval time depth (cfg.td = 3, not td0 = 2), against the JAX
    package's; then the same samples in three sub-batches (the element cap
    lowered), each drawing its rows of the gate and the noise."""
    cj, ct, (params, state) = sampler_cfgs(seed=4, num_samples=5)
    assert ct.td != thw(ct, 0)[0]
    want = np.asarray(jeval.generate_samples(cj, params, state, ndim=3,
                                             seed=5, train_mode=train))
    _, ks = jax.random.split(jax.random.PRNGKey(5))
    draws = sampler_draws(cj, ks, 5, train)
    assert draws[1][1].shape == (5, 3, 12, 17, 1)
    G = port_nb(ct, params, state)
    noise = replay(draws)
    got = teval.generate_samples(ct, G, ndim=3, train_mode=train,
                                 noise=noise)
    assert not noise.drawn
    assert got.shape == want.shape == (5,) + thw(cj, cj.stop_scale) + (3,)
    np.testing.assert_allclose(got, want, **GEN_TOL)

    per = tsampling.generator_elements(ct, G, 3, teval.eval_z_tail(ct, 3))
    monkeypatch.setattr(tsampling, "MAX_ELEMENTS", 2 * per)
    parts = tsampling.sub_batches(5, per)
    assert parts == [(0, 1), (1, 3), (3, 5)]
    noise = replay(split_draws(draws, parts))
    split = teval.generate_samples(ct, G, ndim=3, train_mode=train,
                                   noise=noise)
    assert not noise.drawn
    np.testing.assert_allclose(split, want, **GEN_TOL)


def test_sampled_svfid_matches_jax(shim):
    """On-device SVFID (per-sample C3D statistics, one copy to the host)
    of 3 samples against the JAX package's, and the kept samples."""
    cj, ct, (params, state) = sampler_cfgs(seed=8)
    real = s3._smooth_videos(9, 1)[0]
    key = jax.random.PRNGKey(12)
    z_tail = teval.eval_z_tail(ct, 3)
    want, want_k = jsampling.sampled_svfid(cj, params, state, real, 3, key,
                                           mesh=make_mesh(1), z_tail=z_tail,
                                           return_samples=3)
    noise = replay(sampler_draws(cj, key, 3, True))
    got, got_k = tsampling.sampled_svfid(ct, port_nb(ct, params, state),
                                         real, 3, noise, z_tail=z_tail,
                                         return_samples=3)
    assert not noise.drawn
    assert got_k.shape == (3, 3, 24, 33, 3)
    np.testing.assert_allclose(got_k, np.asarray(want_k), **GEN_TOL)
    assert all(np.isfinite(got)) and min(got) > 0
    np.testing.assert_allclose(got, want, **FID_TOL)


def write_experiment(root, seed=0):
    """A 3D GeneratorVAE_nb experiment dir in the JAX package's format at
    scale 4."""
    cj = jcfg.Config(**s3.CFG, **NB).finalize()
    jvideo.SingleVideoDataset(cj)  # sets org_fps, ar, fps_lcm
    params, state = jax_nb(cj, cj.stop_scale, seed=seed)
    exp = root / "exp"
    exp.mkdir()
    cj.write_args_txt(str(exp / "args.txt"))
    (exp / "intermediate.json").write_text(json.dumps(
        {"noise_amps": s3.AMPS, "scale_idx": cj.stop_scale}))
    with open(exp / f"netG_{cj.stop_scale}.ckpt", "wb") as f:
        pickle.dump({"params": params, "state": state}, f)
    return exp, params, state


@pytest.mark.parametrize("on_device", [False, True])
def test_eval_video_cli_scores_a_jax_experiment(tmp_path, capsys,
                                                on_device):
    """The port's eval_video on a JAX-format GeneratorVAE_nb experiment,
    with and without --on-device-fid: one finite SVFID, the samples at
    scale 4 and metrics.json."""
    exp, _, _ = write_experiment(tmp_path)
    teval_cli.main(["--exp-dir", str(exp), "--device", "cpu",
                    "--num-samples", "3", "--max-samples", "2"]
                   + (["--on-device-fid"] if on_device else []))
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SVFID: ")]
    assert len(line) == 1
    svfid = float(line[0].split()[1])
    assert np.isfinite(svfid) and svfid >= 0
    samples = np.load(exp / "eval" / "random_samples.npy")
    # (N, C, T, H, W): every sample, or --max-samples of them on the device
    assert samples.shape == (2 if on_device else 3, 3, 3, 24, 33)
    assert np.isfinite(samples).all() and np.abs(samples).max() <= 1
    rec = json.loads((exp / "eval" / "metrics.json").read_text())
    assert rec["metric"] == "SVFID" and rec["value"] == svfid
    assert rec["on_device_fid"] is on_device and rec["num_samples"] == 3


# ---------------------------------------------------------- converters ---

def test_converters_round_trip_the_3d_bern_head(tmp_path):
    """The bern head (1, nfc, 3, 3, 3) through from_jax / to_jax bit for
    bit; the reference formats against the JAX package's converters: .pth
    (p2t == from_jax of p2j), MindSpore (t2m == j2m, m2t == from_jax of
    m2j, through the file codec), and load_generator reads both into the
    same model."""
    cj, ct = cfgs()
    params, state = jax_nb(cj, 2, seed=2)
    sd = tconvert.from_jax(params, state, ndim=3)
    assert sd["encode.bern.conv.weight"].shape == (1, 8, 3, 3, 3)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           to_jax3(sd), (params, state))
    pth = {"state_dict": {k: v.numpy() for k, v in sd.items()}}
    pp, ps = jconvert.p2j_HPVAEGAN(pth, ndim=3)
    for k, v in tconvert.p2t_HPVAEGAN(pth).items():
        np.testing.assert_array_equal(
            v.numpy(), tconvert.from_jax(pp, ps, 3)[k].numpy(), err_msg=k)
    ms = tconvert.t2m_HPVAEGAN(sd, 3)
    want = jconvert.j2m_HPVAEGAN(params, state, ndim=3)
    assert sorted(ms) == sorted(want) and "encode._bern.0.weight" in ms
    for k in want:
        np.testing.assert_array_equal(ms[k], np.asarray(want[k]), err_msg=k)
    path = str(tmp_path / "netG_2.ms.ckpt")
    tms.save_ms_checkpoint(ms, path)
    mp, mst = jconvert.m2j_HPVAEGAN(jms.load_ms_checkpoint(path), ndim=3)
    back = tconvert.m2t_HPVAEGAN(tms.load_ms_checkpoint(path))
    want_sd = tconvert.from_jax(mp, mst, 3)
    assert sorted(back) == sorted(want_sd) == sorted(
        k for k in sd if "num_batches" not in k)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), want_sd[k].numpy(),
                                      err_msg=k)
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


# -------------------------------------------------------------- serving ---

@pytest.mark.parametrize("batch", [1, 2, 3])
def test_serving_module_matches_jax(shim, batch):
    """The port's serving module of the 3D GeneratorVAE_nb equals JAX
    make_serving_fn (jit, CPU) for the same noise_init, amps and seed: the
    three-way key split, the gate from kb and the noise from kr in the JAX
    seed stream; BatchNorm's running statistics untouched."""
    cj, ct = cfgs()
    params, state = jax_nb(cj, cj.stop_scale, seed=1)
    G = port_nb(ct, params, state)
    rng = np.random.RandomState(batch)
    z_spec, amps_spec, _ = serving.serving_input_specs(ct, 3, batch)
    z = rng.standard_normal(z_spec.shape).astype(np.float32)
    amps = rng.uniform(0.05, 0.5, amps_spec.shape).astype(np.float32)
    amps[0] = 1.0
    fn = jax.jit(jexport.make_serving_fn(cj, params, state, 3))
    want = np.asarray(fn(z, amps, np.int32(11)))
    module = serving.ServingModule(G)
    assert module.gated and isinstance(G, GeneratorVAE_nb)
    before = {k: v.clone() for k, v in G.state_dict().items()}
    with torch.no_grad():
        got = module(torch.from_numpy(z), torch.from_numpy(amps),
                     torch.tensor(11, dtype=torch.int32)).numpy()
    assert got.shape == want.shape == (batch, 3) + thw(cj, cj.stop_scale)
    np.testing.assert_allclose(got, want, **GEN_TOL)
    for k, v in G.state_dict().items():
        assert torch.equal(v, before[k]), k
