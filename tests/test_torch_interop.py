"""The port's checkpoint and metric-weight interop held against the JAX
package's on the CPU: the MindSpore codec (tools/ms_ckpt.py), the .pth and
MindSpore converters (tools/convert.py's p2t_*, m2t_*, t2m_*, j2m_*),
`load_generator` and the trainer's --netG resume from either format,
tools/export_ms.py and tools/metric_weights.py.

Checkpoints are synthetic, as the JAX package's own tests build them
(tests/test_convert.py::_fake_torch_netG, tests/test_ms_ckpt.py's
reference p2m mappers). The port's state_dicts use the reference's names
and layouts, so the converters are held bit for bit: p2t == from_jax of
p2j, m2t == from_jax of m2j, t2m == j2m. Forwards from converted weights
agree at the per-op tolerance (rtol 1e-4, atol 2e-5).
"""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu import models as jmodels
from hpvaegan_tpu.config import Config as JConfig
from hpvaegan_tpu.tools import convert as jconvert
from hpvaegan_tpu.tools import export_ms as jexport_ms
from hpvaegan_tpu.tools import metric_weights as jmetric_weights
from hpvaegan_tpu.tools import ms_ckpt as jms
from hpvaegan_tpu.utils.pyramid import scale_size_2d

from hpvaegan_tpu_torch import evaluation as teval
from hpvaegan_tpu_torch import models as tmodels
from hpvaegan_tpu_torch import train_image as timage_cli
from hpvaegan_tpu_torch import train_video_baselines as tbaselines_cli
from hpvaegan_tpu_torch.config import Config as TConfig
from hpvaegan_tpu_torch.metrics import c3d as tc3d
from hpvaegan_tpu_torch.metrics import inception as tinception
from hpvaegan_tpu_torch.tools import convert as tconvert
from hpvaegan_tpu_torch.tools import export_ms as texport_ms
from hpvaegan_tpu_torch.tools import metric_weights as tmetric_weights
from hpvaegan_tpu_torch.tools import ms_ckpt as tms
from hpvaegan_tpu_torch.training import trainer as ttrainer
from hpvaegan_tpu_torch.utils.noise import NoiseSource

import test_torch_sampling as s2
import test_torch_video as s3
from test_convert import _fake_torch_netG
from test_ms_ckpt import (_fake_torch_netD, _fake_torch_netG_3d, _p2m_netD,
                          _p2m_netG, _p2m_netG_3d)
from test_torch_trainer import TINY, restore_logging  # noqa: F401

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)
KW = dict(nfc=8, latent_dim=8, num_layer=1, enc_blocks=1, img_size=24,
          min_size=12, max_size=24, vae_levels=1)  # tests/test_convert.py


def _cfgs(**kw):
    out = []
    for mod in (JConfig, TConfig):
        c = mod(**{**KW, **kw}).finalize()
        c.ar = 1.0
        out.append(c)
    return out


def _sd_equal(got, want):
    """Two state_dicts (tensors or arrays) hold the same keys and values,
    bit for bit."""
    assert sorted(got) == sorted(want)
    for k in want:
        a = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        b = want[k].numpy() if torch.is_tensor(want[k]) else want[k]
        assert a.dtype == b.dtype == np.float32, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _port_g(ct, sd, ndim=2):
    gen = tmodels.get_generator("GeneratorHPVAEGAN", ndim)(ct)
    while len(gen.body) < len({k.split(".")[1] for k in sd
                               if k.startswith("body.")}):
        gen.init_next_stage()
    gen.load_state_dict(sd)
    return gen


# ---------------------------------------------------------- ms_ckpt ---

def test_ms_wire_roundtrip_and_bytes_equal_jax(tmp_path):
    """Every dtype round-trips; for the same arrays the port writes the
    JAX package's bytes, and each reads the other's file."""
    rng = np.random.RandomState(0)
    tensors = {
        "a.weight": rng.randn(4, 3, 3, 3).astype(np.float32),
        "a.bias": rng.randn(4).astype(np.float32),
        "scalar": np.float32(2.5).reshape(()),
        "ints": np.arange(7, dtype=np.int64),
        "half": rng.randn(2, 5).astype(np.float16),
        "flags": np.array([True, False]),
    }
    mine, theirs = tmp_path / "port.ckpt", tmp_path / "jax.ckpt"
    tms.save_ms_checkpoint(tensors, str(mine))
    jms.save_ms_checkpoint(tensors, str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    for back in (tms.load_ms_checkpoint(str(theirs)),
                 jms.load_ms_checkpoint(str(mine))):
        assert set(back) == set(tensors)
        for k, v in tensors.items():
            # both write a 0-d array as shape (1,) (np.ascontiguousarray)
            assert back[k].dtype == v.dtype
            assert back[k].shape == np.ascontiguousarray(v).shape
            np.testing.assert_array_equal(back[k], v)
    # torch tensors are written as their arrays
    tms.save_ms_checkpoint({k: torch.from_numpy(v) for k, v in
                            tensors.items() if k != "scalar"},
                           str(tmp_path / "t.ckpt"))
    back = tms.load_ms_checkpoint(str(tmp_path / "t.ckpt"))
    np.testing.assert_array_equal(back["a.weight"], tensors["a.weight"])


def test_ms_bf16_widens_exactly(tmp_path):
    """A bf16 tensor is written as BFloat16 (the JAX package reads it as
    its bfloat16), and BFloat16 loads as the equal float32."""
    import ml_dtypes

    x = torch.linspace(-3, 3, 12).reshape(3, 4).to(torch.bfloat16)
    path = tmp_path / "b.ckpt"
    tms.save_ms_checkpoint({"x": x}, str(path))
    theirs = jms.load_ms_checkpoint(str(path))["x"]
    assert theirs.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(theirs.astype(np.float32),
                                  x.float().numpy())
    back = tms.load_ms_checkpoint(str(path))["x"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, x.float().numpy())
    jpath = tmp_path / "j.ckpt"
    jms.save_ms_checkpoint({"y": theirs}, str(jpath))
    tms.save_ms_checkpoint({"y": theirs}, str(tmp_path / "k.ckpt"))
    assert jpath.read_bytes() == (tmp_path / "k.ckpt").read_bytes()


def test_ms_malformed_input_fails_loudly(tmp_path):
    path = tmp_path / "x.ckpt"
    tms.save_ms_checkpoint({"a.weight": np.ones((4, 4), np.float32),
                            "b.weight_u": np.ones((4, 1), np.float32)},
                           str(path))
    blob = path.read_bytes()
    cases = [(blob[:-7], "truncated"),          # inside the last payload
             (b"\x0a\xff\xff", "truncated"),   # a cut varint
             (b"\x0a\x05proto", "wire type"),  # not a Checkpoint
             (blob.replace(b"Float32", b"Float99"), "tensor_type")]
    for data, match in cases:
        path.write_bytes(data)
        with pytest.raises(ValueError, match=match):
            tms.load_ms_checkpoint(str(path))
    with pytest.raises(ValueError, match="unsupported"):
        tms.save_ms_checkpoint({"x": np.zeros(2, np.complex64)},
                               str(tmp_path / "c.ckpt"))
    empty = tmp_path / "empty.ckpt"
    empty.write_bytes(b"")
    assert not tms.is_ms_checkpoint(str(empty))
    assert tms.load_ms_checkpoint(str(empty)) == {}


def test_content_sniff_tells_pickles_from_checkpoints(tmp_path):
    ms_path = tmp_path / "ms.ckpt"
    tms.save_ms_checkpoint({"x": np.ones(3, np.float32)}, str(ms_path))
    pk_path = tmp_path / "ours.ckpt"
    with open(pk_path, "wb") as f:
        pickle.dump({"params": {"w": np.ones(3)}}, f)
    pth = tmp_path / "netG.pth"
    torch.save({"state_dict": {}}, pth)
    assert tms.is_ms_checkpoint(str(ms_path))
    assert not tms.is_ms_checkpoint(str(pk_path))
    assert not tms.is_ms_checkpoint(str(pth))


# ------------------------------------------------------- converters ---

@pytest.mark.parametrize("ndim", [2, 3])
def test_pth_to_port_equals_p2j(ndim):
    """.pth -> port is a rename: num_batches_tracked goes, the rest loads
    as is; it equals from_jax of the JAX package's p2j."""
    cj, ct = _cfgs()
    pth = (_fake_torch_netG(cj, n_stages=2) if ndim == 2
           else _fake_torch_netG_3d(cj, n_stages=2))
    got = tconvert.p2t_HPVAEGAN(pth)
    params, state = jconvert.p2j_HPVAEGAN(pth, ndim=ndim)
    _sd_equal(got, tconvert.from_jax(params, state, ndim))
    gen = _port_g(ct, got, ndim)
    assert len(gen.body) == 2


def test_pth_generator_forward_matches_p2j():
    """The same weights through the JAX forward (p2j) and the port's
    (p2t): batch-statistics BatchNorm, refinement amps 0."""
    cj, ct = _cfgs()
    pth = _fake_torch_netG(cj, n_stages=2, seed=4)
    params, state = jconvert.p2j_HPVAEGAN(pth, ndim=2)
    gen = _port_g(ct, tconvert.p2t_HPVAEGAN(pth))
    h0, w0 = scale_size_2d(0, cj.scale_factor, cj.stop_scale,
                              cj.img_size, 1.0)
    z = np.random.RandomState(5).randn(2, h0, w0, 8).astype(np.float32)
    amps = np.zeros(cj.stop_scale + 2, np.float32)
    amps[0] = 1.0
    _, g_apply = jmodels.get_generator("GeneratorHPVAEGAN", 2)
    (want, _, _, _), _ = g_apply(cj, params, state, video=None,
                                 amps=jnp.asarray(amps),
                                 noise_init=jnp.asarray(z),
                                 key=jax.random.PRNGKey(0), is_random=True,
                                 train=True)
    with torch.no_grad():
        got, _ = gen(torch.from_numpy(z).permute(0, 3, 1, 2).contiguous(),
                     amps, NoiseSource(0, "cpu"), bn="batch")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


def _fake_netd_3d(cfg, seed=2):
    """tests/test_ms_ckpt.py::_fake_torch_netD with 3x3x3 kernels."""
    rng = np.random.RandomState(seed)
    sd = {}

    def snconv(prefix, cin, cout):
        sd[f"{prefix}.weight_orig"] = rng.randn(cout, cin, 3, 3, 3).astype(
            np.float32) * 0.05
        sd[f"{prefix}.bias"] = np.zeros(cout, np.float32)
        sd[f"{prefix}.weight_u"] = rng.randn(cout).astype(np.float32)
        sd[f"{prefix}.weight_v"] = rng.randn(cin * 27).astype(np.float32)

    snconv("head.conv", cfg.nc_im, cfg.nfc)
    for i in range(cfg.num_layer):
        snconv(f"body.block{i}.conv", cfg.nfc, cfg.nfc)
    sd["tail.weight"] = rng.randn(1, cfg.nfc, 3, 3, 3).astype(
        np.float32) * 0.05
    sd["tail.bias"] = np.zeros(1, np.float32)
    return {"state_dict": sd}


@pytest.mark.parametrize("ndim", [2, 3])
def test_discriminator_pth_and_ms_match_jax(ndim):
    """netD: .pth and MindSpore -> port equal the JAX package's p2j / m2j,
    and the port's D scores as the JAX one does on the same input."""
    cj, ct = _cfgs()
    pth = _fake_torch_netD(cj) if ndim == 2 else _fake_netd_3d(cj)
    sd = pth["state_dict"]
    params, state = jconvert.p2j_WDiscriminator(pth, ndim=ndim)
    want_sd = tconvert.from_jax_discriminator(params, state, ndim)
    _sd_equal(tconvert.p2t_WDiscriminator(pth), want_sd)
    mp, ms_ = jconvert.m2j_WDiscriminator(_p2m_netD(sd), ndim=ndim)
    _sd_equal(tconvert.m2t_WDiscriminator(_p2m_netD(sd)),
              tconvert.from_jax_discriminator(mp, ms_, ndim))
    name = "WDiscriminator2D" if ndim == 2 else "WDiscriminator3D"
    D = tmodels.get_discriminator(name, ndim)(ct)
    D.load_state_dict(tconvert.m2t_WDiscriminator(_p2m_netD(sd)))
    shape = (1, 12, 12, 3) if ndim == 2 else (1, 4, 12, 12, 3)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    _, d_apply = jmodels.get_discriminator(name, ndim)
    want, _ = d_apply(cj, params, state, jnp.asarray(x))
    with torch.no_grad():
        got, _ = D(torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(x, -1, 1))))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("layout", ["2d", "3d", "raw"])
def test_ms_generator_to_port_equals_m2j(tmp_path, layout):
    """MindSpore -> port through the file format: p2m's names in 2D and 3D
    (1.bn2d.), and a cell saved without the 'body.' prefix (the
    reference's m2m layout)."""
    cj, _ = _cfgs()
    ndim = 3 if layout == "3d" else 2
    pth = (_fake_torch_netG_3d(cj, n_stages=3) if ndim == 3
           else _fake_torch_netG(cj, n_stages=3))
    ms = (_p2m_netG_3d if ndim == 3 else _p2m_netG)(pth["state_dict"])
    if layout == "raw":
        raw = {}
        for k, v in ms.items():
            segs = k.split(".")
            if segs[0] == "body":
                segs = segs[1:]
                if len(segs) >= 5 and segs[:2] == ["0", "0"]:
                    segs = segs[2:]
            raw[".".join(segs)] = v
        ms = raw
    path = str(tmp_path / "netG.ckpt")
    tms.save_ms_checkpoint(ms, path)
    got = tconvert.m2t_HPVAEGAN(tms.load_ms_checkpoint(path))
    params, state = jconvert.m2j_HPVAEGAN(jms.load_ms_checkpoint(path),
                                          ndim=ndim)
    _sd_equal(got, tconvert.from_jax(params, state, ndim))
    _sd_equal(got, tconvert.p2t_HPVAEGAN(pth))


@pytest.mark.parametrize("ndim", [2, 3])
def test_port_to_ms_equals_j2m_and_inverts(tmp_path, ndim):
    """port -> MindSpore equals the JAX package's j2m (names and values),
    JAX's m2j reads it back to the same pytree, and JAX's j2m output reads
    into the port unchanged."""
    cj, ct = _cfgs()
    g_init, _ = jmodels.get_generator("GeneratorHPVAEGAN", ndim)
    params, state = g_init(cj, jax.random.PRNGKey(0))
    from hpvaegan_tpu.models import networks_2d, networks_3d

    grow = (networks_2d if ndim == 2 else networks_3d
            ).generator_init_next_stage
    for i in range(2):
        params, state = grow(cj, params, state, jax.random.PRNGKey(i + 1))
    sd = tconvert.from_jax(params, state, ndim)
    ms = tconvert.t2m_HPVAEGAN(sd, ndim)
    want = jconvert.j2m_HPVAEGAN(params, state, ndim=ndim)
    _sd_equal(ms, want)
    _sd_equal(tconvert.j2m_HPVAEGAN(params, state, ndim), want)
    path = str(tmp_path / "rt.ckpt")
    tms.save_ms_checkpoint(ms, path)
    back_p, back_s = jconvert.m2j_HPVAEGAN(jms.load_ms_checkpoint(path),
                                           ndim=ndim)
    for a, b in zip(jax.tree_util.tree_leaves((back_p, back_s)),
                    jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _sd_equal(tconvert.m2t_HPVAEGAN(want), sd)
    assert "encode._features.0.0.weight_u" in ms
    assert ms["encode._features.0.0.weight_u"].ndim == 2


def test_vae_nb_bern_head_round_trips():
    """GeneratorVAE_nb's Bernoulli head maps to _bern and back."""
    _, ct = _cfgs()
    gen = tmodels.get_generator("GeneratorVAE_nb", 2)(ct)
    gen.init_next_stage(torch.Generator().manual_seed(0))
    sd = gen.state_dict()
    ms = tconvert.t2m_HPVAEGAN(sd, 2)
    assert "encode._bern.0.weight" in ms
    _sd_equal(tconvert.m2t_HPVAEGAN(ms), sd)


def test_missing_sn_vectors_are_synthesised_as_jax_does():
    """A .pth without weight_u / weight_v gets the JAX package's
    RandomState(0) unit vectors, v re-ordered to the port's flattening."""
    cj, _ = _cfgs()
    pth = _fake_torch_netG(cj, n_stages=1)
    sd = {k: v for k, v in pth["state_dict"].items()
          if not k.endswith(("weight_u", "weight_v"))}
    params, state = jconvert.p2j_HPVAEGAN(sd, ndim=2)
    _sd_equal(tconvert.p2t_HPVAEGAN(sd), tconvert.from_jax(params, state, 2))


def test_wrong_checkpoint_type_is_refused():
    netd_like = {"head.0.weight": np.ones((8, 3, 3, 3), np.float32),
                 "head.0.weight_u": np.ones((8, 1), np.float32),
                 "tail.weight": np.ones((1, 8, 3, 3), np.float32)}
    with pytest.raises(ValueError, match="wrong checkpoint type"):
        tconvert.m2t_HPVAEGAN(netd_like)
    with pytest.raises(ValueError, match="wrong checkpoint type"):
        tconvert.m2t_WDiscriminator({"encode._mu.0.weight": np.ones(3)})


# ----------------------------------------------------- load_generator ---

def _foreign_files(exp, scale=4):
    """netG.pth (the original layout) and netG_ms.ckpt (MindSpore) of the
    experiment's pickled netG_4, through the port's own converters."""
    with open(exp / "netG_4.ckpt", "rb") as f:
        ckpt = pickle.load(f)
    sd = tconvert.from_jax(ckpt["params"], ckpt["state"])
    torch.save({"scale": scale, "state_dict": sd,
                "noise_amps": s2.AMPS[:scale + 1]}, exp / "netG.pth")
    tms.save_ms_checkpoint(tconvert.t2m_HPVAEGAN(sd, 2),
                           str(exp / "netG_ms.ckpt"))


def test_load_generator_reads_pth_and_ms(tmp_path):
    """Both formats give samples equal, bit for bit, to the pickled
    pytree's from the same weights; the .pth's scale and amps are used;
    a stage-count mismatch is refused."""
    exp = s2._write_experiment(tmp_path)
    _foreign_files(exp)

    def samples(netG):
        cfg = teval.hydrate_config(str(exp), dict(
            niter=1, num_samples=2, scale_idx=-1, netG=netG))
        gen, _ = teval.load_generator(cfg, str(exp), netG=netG, device="cpu")
        return cfg, teval.generate_samples(cfg, gen, seed=3)

    _, want = samples("")
    for name in ("netG.pth", "netG_ms.ckpt"):
        cfg, got = samples(str(exp / name))
        np.testing.assert_array_equal(got, want)
        assert cfg.scale_idx == 4 and cfg.Noise_Amps == s2.AMPS
    _foreign_files(exp, scale=3)
    with pytest.raises(RuntimeError, match="4 refinement stages"):
        samples(str(exp / "netG.pth"))


# ------------------------------------------------------------ resume ---

def _reference_experiment(root, k=4):
    """A reference-trained experiment as a port user would get it: a
    MindSpore netG with k stages, a MindSpore netD_<k-1> and an
    intermediate.json without "torch_rng" (tests/test_ms_ckpt.py::
    test_train_resume_from_ms_checkpoint's files at the CLI's TINY
    config)."""
    cj = JConfig(nfc=8, latent_dim=8, num_layer=1, enc_blocks=1,
                 img_size=32, min_size=16, max_size=32).finalize()
    ref = root / "ref"
    ref.mkdir()
    pth = _fake_torch_netG(cj, n_stages=k)
    tms.save_ms_checkpoint(_p2m_netG(pth["state_dict"]),
                           str(ref / "netG_ms.ckpt"))
    netd = _fake_torch_netD(cj)["state_dict"]
    tms.save_ms_checkpoint(_p2m_netD(netd), str(ref / f"netD_{k - 1}.ckpt"))
    amps = [1.0, 0.3, 0.2, 0.1, 0.05][:k + 1]
    (ref / "intermediate.json").write_text(json.dumps(
        {"noise_amps": amps, "scale_idx": k}))
    torch.save({"scale": k, "noise_amps": amps, "state_dict": {
        key: torch.as_tensor(v) for key, v in pth["state_dict"].items()}},
        ref / "netG.pth")
    return ref, pth, netd, amps


@pytest.mark.parametrize("fmt", ["ms", "pth"])
def test_train_resumes_from_a_reference_checkpoint(tmp_path, monkeypatch,
                                                   restore_logging, fmt):
    """--netG on a MindSpore or .pth generator retrains the marker's scale
    k from its weights (G starts from exactly them) with D warm-started
    from the MindSpore netD_<k-1> beside it, and completes: netG_k in the
    new experiment, the amps' first k kept."""
    ref, pth, netd, amps = _reference_experiment(tmp_path)
    seen = {}

    def spy_d(*args, **kw):
        D = make_d(*args, **kw)
        seen.setdefault("D", {k: v.clone() for k, v in
                              D.state_dict().items()})
        return D

    def spy_scales(cfg, G, *args, **kw):
        seen["G"] = {k: v.clone() for k, v in G.state_dict().items()}
        return train_scales(cfg, G, *args, **kw)

    train_scales = ttrainer.train_scales
    monkeypatch.setattr(ttrainer, "train_scales", spy_scales)
    make_d = ttrainer.make_discriminator
    monkeypatch.setattr(ttrainer, "make_discriminator", spy_d)
    netg = ref / ("netG_ms.ckpt" if fmt == "ms" else "netG.pth")
    exp = timage_cli.main(TINY + ["--niter", "1", "--run-dir",
                                  str(tmp_path / "run"), "--netG", str(netg),
                                  "--intermediate",
                                  str(ref / "intermediate.json")])
    files = set(os.listdir(exp))
    assert "netG_4.ckpt" in files and "netD_4.ckpt" in files
    assert not any(f.startswith("netG_3") for f in files)
    inter = json.loads(open(os.path.join(exp, "intermediate.json")).read())
    assert inter["scale_idx"] == 4 and len(inter["noise_amps"]) == 5
    assert inter["noise_amps"][:4] == amps[:4]
    _sd_equal(seen["G"], tconvert.p2t_HPVAEGAN(pth))
    _sd_equal(seen["D"], tconvert.p2t_WDiscriminator({"state_dict": netd}))


def test_baselines_refuse_foreign_generators(tmp_path, restore_logging):
    """train_video_baselines resumes from pickled pytrees only, as the JAX
    baselines trainer does."""
    ref, _, _, _ = _reference_experiment(tmp_path)
    vid = os.path.join(s3.VIDS, "synthetic.avi")
    for netg in ("netG.pth", "netG_ms.ckpt"):
        with pytest.raises(ValueError, match="pickled"):
            tbaselines_cli.main([
                "--video-path", vid, "--sampling-rates", "2", "1",
                "--max-frames", "5", "--device", "cpu", "--nfc", "4",
                "--num-layer", "1", "--niter", "1", "--img-size", "24",
                "--min-size", "16", "--max-size", "24",
                "--run-dir", str(tmp_path / "b"), "--netG", str(ref / netg),
                "--intermediate", str(ref / "intermediate.json")])


# --------------------------------------------------------- export_ms ---

@pytest.mark.parametrize("ndim", [2, 3])
def test_export_ms_writes_what_jax_writes(tmp_path, monkeypatch, ndim):
    exp = (s2 if ndim == 2 else s3)._write_experiment(tmp_path)
    monkeypatch.setattr(sys, "argv", ["export_ms", str(exp), "-o",
                                      str(tmp_path / "jax.ckpt")])
    jexport_ms.main()
    out = texport_ms.main([str(exp)])
    assert out == str(exp / "netG_4.ms.ckpt")
    _sd_equal(tms.load_ms_checkpoint(out),
              tms.load_ms_checkpoint(str(tmp_path / "jax.ckpt")))
    assert (tmp_path / "jax.ckpt").read_bytes() == open(out, "rb").read()


# ----------------------------------------------------- metric_weights ---

def _torchvision_inception(seed):
    """A torchvision-style InceptionV3 state_dict of every block."""
    rng = np.random.RandomState(seed)
    sd = {}
    specs = [s for block in tinception._BLOCKS for s in block]
    for name, cin, cout, k in tinception._iter_convs(specs, 3):
        sd[f"{name}.conv.weight"] = torch.from_numpy(
            rng.randn(cout, cin, *k).astype(np.float32) * 0.1)
        sd[f"{name}.bn.weight"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, cout).astype(np.float32))
        for b in ("bias", "running_mean"):
            sd[f"{name}.bn.{b}"] = torch.from_numpy(
                0.1 * rng.randn(cout).astype(np.float32))
        sd[f"{name}.bn.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, cout).astype(np.float32))
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    sd["fc.weight"] = torch.zeros(10, 2048)
    return sd


def _c3d_pytorch(seed):
    rng = np.random.RandomState(seed)
    sd = {}
    for name, cin, cout in (("conv1", 3, 64), ("conv2", 64, 128),
                            ("conv3a", 128, 256), ("conv3b", 256, 256),
                            ("conv4a", 256, 512), ("conv4b", 512, 512)):
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.randn(cout, cin, 3, 3, 3).astype(np.float32) * 0.02)
        sd[f"{name}.bias"] = torch.from_numpy(
            rng.randn(cout).astype(np.float32) * 0.1)
    sd["fc6.weight"] = torch.zeros(4, 8)
    return sd


@pytest.mark.parametrize("kind", ["inception", "c3d"])
def test_metric_weights_write_what_jax_writes(tmp_path, kind):
    """The CLI on a torch.save'd state_dict writes the JAX converter's
    arrays, and the metric networks load them as their full weights."""
    sd = _torchvision_inception(0) if kind == "inception" \
        else _c3d_pytorch(1)
    src = tmp_path / "src.pth"
    torch.save({"state_dict": sd}, src)
    out = tmp_path / "port.npz"
    tmetric_weights.main([kind, str(src), str(out)])
    fn = jmetric_weights.inception_state_dict_to_npz if kind == "inception" \
        else jmetric_weights.c3d_state_dict_to_npz
    n = fn(sd, str(tmp_path / "jax.npz"))
    with np.load(out) as a, np.load(tmp_path / "jax.npz") as b:
        assert len(a.files) == n
        _sd_equal({k: a[k] for k in a.files}, {k: b[k] for k in b.files})
    if kind == "inception":
        model = tinception.InceptionV3([0, 1, 2, 3], weights=str(out),
                                       device="cpu")
        specs = [s for block in tinception._BLOCKS for s in block]
        assert len(model.params) == 5 * len(list(
            tinception._iter_convs(specs, 3)))
    else:
        model = tc3d.C3D([0, 1, 2, 3], weights=str(out), device="cpu")
        assert len(model.params) == 12 and model.pretrained
