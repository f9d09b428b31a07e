"""The train CLIs on the spatial mesh (--mesh-sp, parallel/spatial.py) over
gloo ranks on the CPU, held against one process at the same global batch.

  (c) train_image on an image pyramid of heights 9, 11, 12, 15, 18 (split
      at S = 2 only at 12 and 18, so every forward mixes sharded and
      replicated stages), also with --paired-g --flat-opt, with --fused-dg
      --visualize (the same images as one process's) and with --generator
      GeneratorVAE_nb; train_video on heights 12, 15,
      17, 20, 24 (every transition between the layouts), also with
      --generator GeneratorVAE_nb (its encoder's mean over (T, H, W) and
      its gate over the spatial ranks); all with
      --mesh-sp 2 on 2 ranks, and train_image with --mesh-data 2
      --mesh-sp 2 on 4 ranks, each at --batch-size 2. Every rank ends with
      bit-equal parameters, rank 0 owns the one experiment dir and the
      others a NullSaver, and the result equals one process at
      --batch-size 2 within atol 1e-4 (test_torch_data_parallel.py's
      multi-scale bar): the parameters and buffers, but for the biases in
      front of BatchNorm and their running means, and the generators'
      samples.
  (d) train_image killed at its last scale under --mesh-sp 2 and resumed
      from its inflight checkpoint ends bit for bit as the uninterrupted
      run over the same ranks: the state is replicated, so the checkpoint
      needs no gather.

The baselines CLI's cases (`baselines`, `baselines-sg`, and the resume's
`kind`) run from tests/test_torch_spatial_baselines_cli.py.

Ranks run this file as a script (test_torch_multihost.py::run_ranks).
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from hpvaegan_tpu_torch import train_image, train_video  # noqa: E402
from hpvaegan_tpu_torch import train_video_baselines  # noqa: E402
from hpvaegan_tpu_torch.training import (baselines_trainer,  # noqa: E402
                                         trainer)

from test_torch_data_parallel import (MULTI_SCALE_TOL,  # noqa: E402
                                      _bias_fed_batchnorm, _samples)
from test_torch_data_parallel import restore_logging  # noqa: E402,F401
from test_torch_multihost import run_ranks, worker_main  # noqa: E402

torch.set_num_threads(1)

DATA = os.path.join(REPO, "data")
IMAGE = ["--image-path", os.path.join(DATA, "imgs", "air_balloons.jpg"),
         "--nfc", "8", "--latent-dim", "8", "--num-layer", "1",
         "--enc-blocks", "1", "--niter", "2", "--img-size", "24",
         "--min-size", "12", "--max-size", "24", "--vae-levels", "2"]
VIDEO = ["--video-path", os.path.join(DATA, "vids", "synthetic.avi"),
         "--sampling-rates", "2", "1", "--max-frames", "5", "--nfc", "8",
         "--latent-dim", "8", "--num-layer", "1", "--enc-blocks", "1",
         "--niter", "2", "--img-size", "32", "--min-size", "16",
         "--max-size", "32", "--vae-levels", "2"]
# the baselines on the video's pyramid: heights 12 15 17 20 24, of which
# 12, 20 and 24 split at S = 4 and at S = 2; num_layer 1: CSG's stages
# pad by 2, SG's by 3, the critic by 3
BASELINES = ["--video-path", os.path.join(DATA, "vids", "synthetic.avi"),
             "--sampling-rates", "2", "1", "--max-frames", "5", "--nfc", "8",
             "--num-layer", "1", "--niter", "2", "--img-size", "32",
             "--min-size", "16", "--max-size", "32"]
CLI_ARGS = {
    "image": IMAGE,
    "image-paired-flat": IMAGE + ["--paired-g", "--flat-opt"],
    # --visualize gathers H before the primary writes its images
    "image-fused": IMAGE + ["--fused-dg", "--visualize", "--image-interval",
                            "2"],
    "image-vae-nb": IMAGE + ["--generator", "GeneratorVAE_nb"],
    "video": VIDEO,
    "video-vae-nb": VIDEO + ["--generator", "GeneratorVAE_nb"],
    "baselines": BASELINES,
    "baselines-sg": BASELINES + ["--generator", "GeneratorSG"],
}
COMMON = ["--checkname", "sp", "--print-interval", "1", "--manualSeed", "1",
          "--device", "cpu", "--batch-size", "2"]


def _cli(kind):
    """The `kind` CLI and the trainer module it runs."""
    if kind.startswith("baselines"):
        return train_video_baselines, baselines_trainer
    return (train_video if kind.startswith("video") else train_image), \
        trainer


def _train(kind, run_dir, extra=(), step_callback=None):
    """The `kind` CLI in this process; the trained G's state_dict, its
    amps, the saver's type and experiment dir."""
    cli, trainer = _cli(kind)
    seen = {}
    run = trainer.run_training

    def spy(cfg, saver, **kw):
        if step_callback is not None:
            kw["step_callback"] = step_callback
        G, amps = run(cfg, saver, **kw)
        seen.update(sd={k: v.clone() for k, v in G.state_dict().items()},
                    amps=[float(a) for a in amps],
                    saver=type(saver).__name__, exp=saver.experiment_dir)
        return G, amps

    trainer.run_training = spy
    try:
        exp = cli.main(CLI_ARGS[kind] + COMMON
                       + ["--run-dir", run_dir] + list(extra))
    finally:
        trainer.run_training = run
    assert exp == seen["exp"]
    return seen


def _batch(kind, data_ranks):
    """The baselines run at --batch-size D; the others at COMMON's 2."""
    return ["--batch-size", str(data_ranks)] if kind.startswith(
        "baselines") else []


def _case_cli(rank, world, out_dir, kind, data_ranks):
    """One rank of the `kind` CLI on the mesh (it joins the ranks itself,
    from its --dist-* flags)."""
    return _train(kind, os.path.join(out_dir, "sp"), [
        "--mesh-data", data_ranks, "--mesh-sp", str(world // int(data_ranks)),
        "--dist-coordinator", f"127.0.0.1:{_case_cli.port}",
        "--dist-nprocs", str(world), "--dist-procid", str(rank)]
        + _batch(kind, data_ranks))


_case_cli.joins_itself = True


@pytest.mark.parametrize("kind,data_ranks", [
    ("image", 1), ("image-paired-flat", 1), ("image-fused", 1),
    ("image-vae-nb", 1), ("video", 1), ("video-vae-nb", 1), ("image", 2)])
def test_spatial_cli_equals_one_process(tmp_path, kind, data_ranks,
                                        restore_logging):
    """--mesh-data D --mesh-sp 2 over D x 2 ranks against one process at
    --batch-size 2."""
    world = 2 * data_ranks
    outs = run_ranks(__file__, "cli", tmp_path, kind, data_ranks,
                     world=world)
    for out in outs[1:]:
        for k, v in outs[0]["sd"].items():
            assert torch.equal(v, out["sd"][k]), k
        assert out["amps"] == outs[0]["amps"]
        assert (out["saver"], out["exp"]) == ("NullSaver", outs[0]["exp"])
    r0 = outs[0]
    assert r0["saver"] == "DataSaver"
    assert glob.glob(os.path.join(tmp_path, "sp", "**", "experiment_*"),
                     recursive=True) == [r0["exp"]]
    names = os.listdir(r0["exp"])
    assert {f"netG_{k}.ckpt" for k in range(5)} <= set(names)
    with open(os.path.join(r0["exp"], "args.txt")) as f:
        args = f.read()
    assert "mesh_sp: 2" in args and f"mesh_data: {data_ranks}" in args

    one = _train(kind, str(tmp_path / "one"))
    np.testing.assert_allclose(r0["amps"], one["amps"], **MULTI_SCALE_TOL)
    absorbed = _bias_fed_batchnorm(one["sd"])
    for k, v in one["sd"].items():
        if k not in absorbed:
            np.testing.assert_allclose(r0["sd"][k].numpy(), v.numpy(),
                                       err_msg=k, **MULTI_SCALE_TOL)
    if kind == "image-fused":
        names = sorted(os.listdir(os.path.join(r0["exp"], "img")))
        assert names == ["fake_vae_var2.jpg", "fake_var_2.jpg",
                         "generated_3.jpg", "generated_vae_3.jpg",
                         "real_3.jpg"]
        assert names == sorted(os.listdir(os.path.join(one["exp"], "img")))
    sample_kind = "video" if kind.startswith("video") else "image"
    np.testing.assert_allclose(_samples(sample_kind, r0["exp"]),
                               _samples(sample_kind, one["exp"]),
                               **MULTI_SCALE_TOL)


class Killed(Exception):
    """What the resume test's step_callback raises to stop a run."""


def _case_resume(rank, world, out_dir, kind="image"):
    """On S = world ranks (joined by the worker): the uninterrupted run of
    the `kind` CLI, the run killed after iteration 2 of 4 at the last
    scale (every rank stops at the same point), and its resume from
    inflight_4.ckpt."""
    extra = ["--mesh-sp", str(world), "--niter", "4", "--ckpt-interval",
             "2"] + _batch(kind, 1)
    whole = _train(kind, os.path.join(out_dir, "a"), extra)

    def kill(done, st, metrics):
        if len(st.G.body) == 4 + st.G.body_offset and done == 2:
            raise Killed

    made = []
    try:
        _train(kind, os.path.join(out_dir, "b"), extra, kill)
    except Killed:
        made = glob.glob(os.path.join(out_dir, "b", "**", "experiment_*"),
                         recursive=True)
    assert len(made) == 1, made
    resumed = _train(kind, os.path.join(out_dir, "c"), extra + [
        "--netG", os.path.join(made[0], "inflight_4.ckpt"),
        "--intermediate", os.path.join(made[0], "intermediate.json")])
    return dict(whole=whole, resumed=resumed)


def test_spatial_inflight_resume_is_exact(tmp_path, restore_logging):
    """A --mesh-sp 2 run killed at its last scale and resumed from its
    inflight checkpoint ends as the uninterrupted one, bit for bit, on
    both ranks."""
    outs = run_ranks(__file__, "resume", tmp_path)
    for out in outs:
        assert out["resumed"]["amps"] == out["whole"]["amps"]
        for k, v in out["whole"]["sd"].items():
            assert torch.equal(out["resumed"]["sd"][k], v), k
            assert torch.equal(outs[0]["whole"]["sd"][k], v), k


CASES = {"cli": _case_cli, "resume": _case_resume}

if __name__ == "__main__":
    worker_main(CASES)
