"""The port's native serving chain (export -> runner -> postprocess) held
against the JAX package's on the CPU: the preprocess bins byte for byte,
io_spec.txt, the exported program on those bins against the JAX CLI's
.stablehlo (atol 1e-4, 2D and 3D), the postprocess PNGs and clips from the
same runner .bin, and a finite SIFID / SVFID. Then the native runner
itself: it compiles an AOTInductor package and the runner, so it is
`slow` on the CPU and `cuda` on the card, where its outputs are held
against the ExportedProgram's (atol 1e-4); and on the card the serving
draw chain compiled by AOTInductor, held to the numpy path bit for bit.

The JAX package is imported inside the tests that compare with it, so that
the runner's test also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_infer_pipeline.py
"""

import glob
import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from hpvaegan_tpu_torch import postprocess as tpost
from hpvaegan_tpu_torch import preprocess as tpre
from hpvaegan_tpu_torch.config import Config
from hpvaegan_tpu_torch.export import __main__ as texport_cli
from hpvaegan_tpu_torch.export import serving
from hpvaegan_tpu_torch.models import get_generator
from hpvaegan_tpu_torch.models.blocks import init_weights_
from hpvaegan_tpu_torch.tools import run_infer
from hpvaegan_tpu_torch.tools.convert import to_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_TOL = dict(rtol=0, atol=1e-4)


def _jax_cli():
    """The JAX package's root export / preprocess / postprocess modules and
    its stablehlo module."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import export as jexport_cli
    import postprocess as jpost
    import preprocess as jpre
    from hpvaegan_tpu.config import Config as JConfig
    from hpvaegan_tpu.export import stablehlo

    return jexport_cli, jpre, jpost, JConfig, stablehlo


def _jax_experiment(root, kind):
    """A JAX-format experiment at scale 4 (tests/test_torch_sampling.py's
    image one, tests/test_torch_video.py's video one)."""
    import test_torch_sampling as s2
    import test_torch_video as s3

    root.mkdir()
    return str((s3 if kind == "3d" else s2)._write_experiment(root))


def _files(infer):
    """The runner's input bins under `infer`, by relative path."""
    return {os.path.relpath(p, infer): open(p, "rb").read()
            for sub in ("noise_init", "noise_amps", "seed")
            for p in sorted(glob.glob(os.path.join(infer, sub, "*.bin")))}


# ---------------------------------------------------------------- preprocess

@pytest.mark.parametrize("kind,num_samples,batch,seed",
                         [("2d", 1, 1, 0), ("2d", 3, 2, 4), ("3d", 2, 1, 1)])
def test_preprocess_bins_equal_jax(tmp_path, kind, num_samples, batch, seed):
    _, jpre, _, JConfig, _ = _jax_cli()
    exp = _jax_experiment(tmp_path / "port", kind)
    jexp = str(tmp_path / "jax")
    shutil.copytree(exp, jexp)
    cfg = Config.from_args_txt(os.path.join(exp, "args.txt"))
    jcfg = JConfig.from_args_txt(os.path.join(jexp, "args.txt"))
    for c in (cfg, jcfg):
        c.batch_size, c.scale_idx = batch, -1
    tpre.pre_process(cfg, exp, seed=seed, num_samples=num_samples)
    jpre.pre_process(jcfg, jexp, seed=seed, num_samples=num_samples)
    got, want = _files(os.path.join(exp, "infer")), \
        _files(os.path.join(jexp, "infer"))
    assert len(got) == num_samples + 2 and got == want
    assert cfg.scale_idx == jcfg.scale_idx == 4


def test_preprocess_serves_last_finalized_scale(tmp_path):
    exp = _jax_experiment(tmp_path / "exp", "2d")
    with open(os.path.join(exp, "intermediate.json"), "w") as f:
        json.dump({"noise_amps": [1.0, 0.3, 0.2, 0.1, 0.05],
                   "scale_idx": 4, "inflight": "inflight_4.ckpt"}, f)
    os.makedirs(os.path.join(exp, "infer", "result"))
    open(os.path.join(exp, "infer", "result", "old_output_0.bin"),
         "wb").write(b"x")
    tpre.main(["--exp-dir", exp, "--num-samples", "1"])
    amps = np.fromfile(os.path.join(exp, "infer", "noise_amps",
                                    "noise_amps.bin"), np.float32)
    np.testing.assert_array_equal(
        amps[:5], np.float32([1.0, 0.3, 0.2, 0.1, 0]))
    assert os.listdir(os.path.join(exp, "infer", "result")) == []


# ------------------------------------------------------ export -> postprocess

def _bins(infer):
    spec = open(os.path.join(infer, "io_spec.txt")).read().splitlines()
    z_shape = tuple(int(d) for d in spec[0].split()[1].split(","))
    noises = sorted(glob.glob(os.path.join(infer, "noise_init", "*.bin")))
    amps = np.fromfile(os.path.join(infer, "noise_amps", "noise_amps.bin"),
                       np.float32)
    seed = np.fromfile(os.path.join(infer, "seed", "seed.bin"), np.int32)[0]
    return [(n, np.fromfile(n, np.float32).reshape(z_shape))
            for n in noises], amps, seed


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_export_cli_matches_jax_cli(tmp_path, monkeypatch, capsys, kind):
    jexport_cli, _, jpost, JConfig, stablehlo = _jax_cli()
    exp = _jax_experiment(tmp_path / "port", kind)
    jexp = str(tmp_path / "jax")
    shutil.copytree(exp, jexp)
    n = 2 if kind == "2d" else 1
    monkeypatch.setattr(sys, "argv", ["export.py", "--exp-dir", jexp,
                                      "--num-samples", str(n)])
    jexport_cli.main()
    texport_cli.main(["--exp-dir", exp, "--device", "cpu",
                      "--num-samples", str(n)])
    infer, jinfer = os.path.join(exp, "infer"), os.path.join(jexp, "infer")
    assert _files(infer) == _files(jinfer) and len(_files(infer)) == n + 2
    assert open(os.path.join(infer, "io_spec.txt")).read() == \
        open(os.path.join(jinfer, "io_spec.txt")).read()
    assert sorted(f for f in os.listdir(infer) if "." in f) == \
        ["io_spec.txt", "netG_4.pt2"]

    # the port's program and the JAX CLI's on the same bins; the JAX one's
    # output is the runner .bin that both postprocesses read
    bins, amps, seed = _bins(infer)
    program = serving.load_serialized(os.path.join(infer, "netG_4.pt2"))
    jprogram = stablehlo.load_serialized(os.path.join(jinfer,
                                                      "netG_4.stablehlo"))
    for name, z in bins:
        got = serving.run_serialized(program, z, amps, seed).numpy()
        want = np.asarray(stablehlo.run_serialized(jprogram, z, amps, seed))
        np.testing.assert_allclose(got, want, **GEN_TOL)
        base = os.path.basename(name)[:-4] + "_output_0.bin"
        for d in (infer, jinfer):
            os.makedirs(os.path.join(d, "result"), exist_ok=True)
            want.tofile(os.path.join(d, "result", base))

    cfg = Config.from_args_txt(os.path.join(exp, "args.txt"))
    jcfg = JConfig.from_args_txt(os.path.join(jexp, "args.txt"))
    for c in (cfg, jcfg):
        c.batch_size, c.scale_idx = 1, 4
    if kind == "2d":
        tpost.post_process(cfg, exp, os.path.join(infer, "result"))
        jpost.post_process(jcfg, jexp, os.path.join(jinfer, "result"))
        pngs = sorted(os.listdir(os.path.join(infer, "images")))
        assert pngs == sorted(os.listdir(os.path.join(jinfer, "images"))) \
            == [f"fake_{i}_0.png" for i in range(n)]
        from PIL import Image
        for p in pngs:
            got = np.asarray(Image.open(os.path.join(infer, "images", p)))
            want = np.asarray(Image.open(os.path.join(jinfer, "images", p)))
            assert got.shape == (33, 33, 3)
            np.testing.assert_array_equal(got, want)
        metric = "SIFID"
    else:
        tpost.post_process_video(cfg, exp, os.path.join(infer, "result"),
                                 device="cpu")
        jpost.post_process_video(jcfg, jexp, os.path.join(jinfer, "result"))
        for sub, f in (("videos", "fake_0_0.npy"),
                       ("real", "real_full_scale.npy")):
            got = np.load(os.path.join(infer, sub, f))
            want = np.load(os.path.join(jinfer, sub, f))
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        assert os.path.isfile(os.path.join(infer, "videos", "fake_0_0.gif"))
        metric = "SVFID"
    capsys.readouterr()
    tpost.main(["--exp-dir", exp, "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(f"{metric}: ")]
    assert len(line) == 1 and np.isfinite(float(line[0].split()[1]))


@pytest.mark.parametrize("cli", [texport_cli, tpost],
                         ids=["export", "postprocess"])
def test_clis_refuse_a_missing_card(tmp_path, cli):
    """The export and postprocess CLIs default to the card and stop before
    writing anything when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--exp-dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------------ native runner

def _port_experiment(root):
    """A tiny image experiment from the port alone (no JAX): a random
    generator at scale 2 as a JAX-layout pickle."""
    cfg = Config(image_path=os.path.join(REPO, "data", "imgs",
                                         "air_balloons.jpg"),
                 nfc=8, latent_dim=8, num_layer=1, enc_blocks=1,
                 img_size=24, min_size=16, max_size=24,
                 vae_levels=2).finalize()
    cfg.ar = 0.75
    gen = get_generator(cfg.generator)(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage()
    init_weights_(gen, torch.Generator().manual_seed(0))
    root.mkdir()
    cfg.write_args_txt(str(root / "args.txt"))
    (root / "intermediate.json").write_text(json.dumps(
        {"noise_amps": [1.0] + [0.2] * cfg.stop_scale,
         "scale_idx": cfg.stop_scale}))
    params, state = to_jax(gen.state_dict())
    with open(root / f"netG_{cfg.stop_scale}.ckpt", "wb") as f:
        pickle.dump({"params": params, "state": state}, f)
    return str(root), cfg.stop_scale


@pytest.fixture(params=[pytest.param("cpu", marks=pytest.mark.slow),
                        pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return request.param


def test_native_runner_matches_exported_program(tmp_path, capsys, device):
    """tools/run_infer.py end to end: export with an AOTInductor package,
    build the runner, run it over 3 bins, postprocess; the runner's .bins
    equal the ExportedProgram's on the same bins (float32 convolutions on
    both sides)."""
    exp, k = _port_experiment(tmp_path / "exp")
    run_infer.main([exp, "--device", device, "--num-samples", "3"])
    out = capsys.readouterr().out
    assert "NN inference cost average time: " in out
    assert "infer_count 3" in out and "SIFID: " in out
    assert os.path.isfile(os.path.join(exp, "time_Result",
                                       "test_perform_static.txt"))
    infer = os.path.join(exp, "infer")
    program = serving.load_serialized(os.path.join(infer, f"netG_{k}.pt2"))
    bins, amps, seed = _bins(infer)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, z in bins:
            want = serving.run_serialized(program, z, amps, seed).cpu()
            got = np.fromfile(os.path.join(
                infer, "result", os.path.basename(name)[:-4]
                + "_output_0.bin"), np.float32).reshape(want.shape)
            np.testing.assert_allclose(got, want.numpy(), **GEN_TOL)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # a bin of the wrong size is refused
    with open(bins[0][0], "ab") as f:
        f.write(b"\0\0\0\0")
    with pytest.raises(RuntimeError, match="input size mismatch"):
        run_infer.main([exp, "--device", device, "--run-only"])


@pytest.mark.cuda
def test_compiled_serving_draws_equal_the_numpy_path(tmp_path):
    """The serving forward's draw chain (ServingModule's key split, then
    utils/noise.py::KeyedNoise drawing every stage's normals up front, as
    the traced forward does), exported and compiled by AOTInductor for the
    card, gives utils/jax_prng.py's numpy path (XLA:CPU's arithmetic) bit
    for bit at three seeds: at a tiny model's stage shapes in 2D and 3D
    and at the last stages of the full-width image (192x257) and video
    (13x192x257) models."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch._inductor import aoti_load_package

    from hpvaegan_tpu_torch.utils import jax_prng
    from hpvaegan_tpu_torch.utils.noise import KeyedNoise

    shapes = [(1, 3, 12, 17), (1, 3, 17, 23), (1, 3, 3, 12, 17),
              (1, 3, 5, 17, 23), (1, 3, 192, 257), (1, 3, 13, 192, 257)]

    class Draws(torch.nn.Module):
        def forward(self, seed):
            keys = jax_prng.split(jax_prng.prng_key(seed)[None], 2)
            noise = KeyedNoise(keys[:, -1], shapes=shapes)
            return tuple(noise.normal(s) for s in shapes)

    exported = torch.export.export(
        Draws(), (torch.tensor(0, dtype=torch.int32, device="cuda"),))
    package = aoti_load_package(serving.compile_native(
        exported, str(tmp_path / "draws.aoti.pt2")))
    for seed in (0, 11, 2 ** 31 - 1):
        got = package(torch.tensor(seed, dtype=torch.int32, device="cuda"))
        keys = jax_prng.split(jax_prng.prng_key(torch.tensor(
            seed, dtype=torch.int32))[None], 2)[:, -1]
        for shape, g in zip(shapes, got):
            pairs = jax_prng.split(keys)
            keys, sub = pairs[:, 0], pairs[0, 1]
            want = np.moveaxis(jax_prng.normal(
                (int(sub[0]), int(sub[1])), KeyedNoise._channels_last(shape)),
                -1, 1)
            np.testing.assert_array_equal(g.cpu().numpy().view(np.int32),
                                          want.view(np.int32))


# AOTInductor's program against the eager ExportedProgram at full width:
# both are float32 but round in another order, and a random full-width
# model amplifies one rounding a thousandfold (on an H100, moving each
# element of noise_init by one ulp moves the output by 2.0e-3, and the
# compiled program differs from the eager one by 3.5e-3)
FULL_WIDTH_COMPILED_TOL = 1e-2


@pytest.mark.cuda
@pytest.mark.slow
def test_compiled_full_width_image_model_matches_exported_program(tmp_path):
    """The full-width image serving model (img 256, nfc 64, num_layer 5,
    latent 128, 10 scales, He-normal weights), exported and compiled by
    AOTInductor for the card, whose kernels Inductor fits to these shapes,
    gives the ExportedProgram's samples within FULL_WIDTH_COMPILED_TOL at
    three noise_inits and seeds (TF32 off); the tiny model's native runner
    is held at 1e-4 (test_native_runner_matches_exported_program)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch._inductor import aoti_load_package

    from hpvaegan_tpu_torch.tools.step_parity import he_init_

    cfg = Config().finalize()
    gen = get_generator(cfg.generator)(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage()
    he_init_(gen, torch.Generator().manual_seed(0))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        exported = serving.export_sampler(cfg, gen.eval(), device="cuda")
        package = aoti_load_package(serving.compile_native(
            exported, str(tmp_path / "netG.aoti.pt2")))
        z_spec, amps_spec, _ = serving.serving_input_specs(cfg)
        amps = torch.tensor([1.0] + [0.3 * 0.8 ** k for k in range(
            amps_spec.shape[0] - 1)], device="cuda")
        g = torch.Generator().manual_seed(1)
        for seed in (0, 11, 2 ** 31 - 1):
            z = torch.randn(z_spec.shape, generator=g).cuda()
            seed = torch.tensor(seed, dtype=torch.int32, device="cuda")
            with torch.no_grad():
                want = serving.run_serialized(exported, z, amps, seed)
                got = package(z, amps, seed)
            assert got.shape == want.shape == (1, 3, 257, 257)
            assert torch.isfinite(want).all()
            assert float((got - want).abs().max()) <= \
                FULL_WIDTH_COMPILED_TOL
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
