"""Data-parallel training and evaluation over two gloo ranks on the CPU,
held against one process at the same global batch and against the JAX
package's `--mesh-data 2` step.

  * One GAN-scale D step and one G step (test_torch_trainer.py's 2D
    state, batch 2) on 2 ranks x 1 row, the JAX draws of one process
    replayed and sliced to each rank's rows, against JAX `make_d_step` /
    `make_g_step` at batch 2 over a ('data', 'sp') mesh of 2 of the
    conftest's virtual CPU devices: metrics rtol 1e-4 / atol 1e-7,
    gradients and BatchNorm / spectral-norm state rtol 1e-4 / atol 2e-5,
    the tolerances of the single-process step-parity tests
    (tests/test_torch_trainer.py); both ranks bit-equal.
  * The three train CLIs (train_image, also with --paired-g --flat-opt
    and with --fused-dg, train_video, and train_video_baselines at 2
    scales) with --dist-* --mesh-data 2 --batch-size 2: both ranks end with bit-equal parameters, rank 0 owns
    the one experiment dir and rank 1 a NullSaver, the result equals one
    process at --batch-size 2 within atol 1e-4 (the multi-scale bar): the
    parameters and buffers, but for the biases in front of BatchNorm and
    their running means (`_bias_fed_batchnorm`), and the generators'
    samples, and
    --on-device-fid SIFID / SVFID over the two ranks is the same number
    on both, within rtol 1e-4 of one process's on the same experiment.

Ranks run this file as a script (test_torch_multihost.py::run_ranks).
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from hpvaegan_tpu_torch import optim as toptim  # noqa: E402
from hpvaegan_tpu_torch.models import (get_discriminator,  # noqa: E402
                                       get_generator)
from hpvaegan_tpu_torch.parallel import mesh, multihost  # noqa: E402
from hpvaegan_tpu_torch.tools.step_parity import ReplayedNoise  # noqa: E402
from hpvaegan_tpu_torch.training import partition as tpart  # noqa: E402
from hpvaegan_tpu_torch.training import steps as tsteps  # noqa: E402
from hpvaegan_tpu_torch.training.state import ScaleTrainState  # noqa: E402

from test_torch_multihost import run_ranks, worker_main  # noqa: E402

torch.set_num_threads(1)

MULTI_SCALE_TOL = dict(rtol=0, atol=1e-4)
FID_TOL = dict(rtol=1e-4)
DATA = os.path.join(REPO, "data")
IMAGE = os.path.join(DATA, "imgs", "air_balloons.jpg")
SYNTHETIC = os.path.join(DATA, "vids", "synthetic.avi")
CLI_ARGS = {
    "image": ["--image-path", IMAGE, "--nfc", "8", "--latent-dim", "8",
              "--num-layer", "1", "--enc-blocks", "1", "--niter", "2",
              "--img-size", "32", "--min-size", "18", "--max-size", "32",
              "--vae-levels", "1"],
    "video": ["--video-path", SYNTHETIC, "--sampling-rates", "2", "1",
              "--max-frames", "5", "--nfc", "8", "--latent-dim", "8",
              "--num-layer", "1", "--enc-blocks", "1", "--niter", "2",
              "--img-size", "32", "--min-size", "24", "--max-size", "32",
              "--vae-levels", "1"],
    "baselines": ["--video-path", SYNTHETIC, "--sampling-rates", "2", "1",
                  "--max-frames", "5", "--nfc", "8", "--num-layer", "1",
                  "--niter", "2", "--img-size", "32", "--min-size", "24",
                  "--max-size", "32"],
}
COMMON = ["--checkname", "dp", "--print-interval", "1", "--manualSeed", "1",
          "--device", "cpu", "--batch-size", "2"]
# the flag variants of the image run: the paired G step's grouped
# BatchNorm (each half's statistics global) with FlatAdam on the averaged
# gradients, and the fused D + G iteration
CLI_ARGS["image-paired-flat"] = CLI_ARGS["image"] + ["--paired-g",
                                                     "--flat-opt"]
CLI_ARGS["image-fused"] = CLI_ARGS["image"] + ["--fused-dg"]
# the 3D GeneratorVAE_nb: each rank draws its rows of the global gate
CLI_ARGS["video-vae-nb"] = CLI_ARGS["video"] + ["--generator",
                                                "GeneratorVAE_nb"]


# ------------------------------------------------------ one D + G step ---

def _rank_rows(t):
    """This rank's rows of a global batch `t`, under the data group in
    force."""
    group = mesh.active()
    b = mesh.local_rows(t.shape[0])
    return t[group.rank * b:(group.rank + 1) * b]


class ShardedReplay(ReplayedNoise):
    """Another run's global draws, in call order, each batched one sliced
    to this rank's rows of the data group in force (a rank asks with its
    own shape); scalars whole."""

    def __init__(self, drawn):
        super().__init__(drawn, "cpu")

    def _next(self, shape):
        t = self.drawn.pop(0)
        if tuple(shape):
            t = _rank_rows(t)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"replayed draw {tuple(t.shape)} for {shape}")
        return t


def _case_step(rank, world, out_dir):
    """The payload's state on this rank: its rows of the batch, the D step
    then the G step over the data group; the metrics, gradients and
    states."""
    p = torch.load(os.path.join(out_dir, "step_in.pt"), weights_only=False)
    ct = p["ct"]
    G = get_generator(ct.generator)(ct)
    for _ in range(p["n_body"]):
        G.init_next_stage()
    G.load_state_dict(p["g"])
    D = get_discriminator(ct.discriminator)(ct)
    D.load_state_dict(p["d"])
    group = mesh.make_data_group(world)
    st = ScaleTrainState(
        G, D, toptim.ClippedAdam(tpart.apply_lr_plan(G, p["plan"]), ct.beta1,
                                 grad_clip=ct.grad_clip),
        toptim.adam(D.parameters(), ct.lr_d, ct.beta1), None)
    out = {}
    with mesh.data_parallel(group):
        real, real_zero, noise_init = (_rank_rows(t) for t in p["batch"])
        st.noise = ShardedReplay(p["d_draws"])
        # the iteration's metrics are the group's means (train_iteration)
        out["d_metrics"] = {k: float(v) for k, v in mesh.mean_metrics(
            tsteps.d_step(ct, st, real, noise_init, p["amps"])).items()}
        out["d_grads"] = {k: q.grad.clone() for k, q in D.named_parameters()}
        out["d_sd"] = {k: v.clone() for k, v in D.state_dict().items()}
        st.noise = ShardedReplay(p["g_draws"])
        out["g_metrics"] = {k: float(v) for k, v in mesh.mean_metrics(
            tsteps.g_step(ct, st, real, real_zero, noise_init, p["amps"],
                          vae_phase=False)).items()}
        assert not st.noise.drawn
    out["g_grads"] = {k: q.grad.clone() for k, q in G.named_parameters()
                      if q.grad is not None}
    out["g_sd"] = {k: v.clone() for k, v in G.state_dict().items()}
    return out


def test_data_parallel_d_and_g_step_match_jax_mesh_data_2(
        tmp_path, monkeypatch):
    """A GAN-scale D step then G step on 2 ranks equal JAX's jitted steps
    over a data=2 mesh at the same global batch of 2."""
    import jax
    import jax.numpy as jnp
    import optax

    from hpvaegan_tpu import optim as joptim
    from hpvaegan_tpu.models import networks_2d as jnet
    from hpvaegan_tpu.parallel.mesh import make_mesh
    from hpvaegan_tpu.training import partition as jpart
    from hpvaegan_tpu.training import steps as jsteps
    from hpvaegan_tpu.training.state import ScaleTrainState as JState

    from hpvaegan_tpu_torch.tools.convert import to_jax, to_jax_discriminator

    import test_torch_trainer as t2
    from test_torch_training import (OP_TOL, assert_trees_close, nchw,
                                     port_discriminator, port_generator,
                                     port_grads)

    drawn = []
    orig = jnet.generate_noise

    def record(key, shape, kind="normal", dtype=jnp.float32):
        out = orig(key, shape, kind, dtype)
        drawn.append((kind, out))
        return out

    monkeypatch.setattr(jnet, "generate_noise", record)

    def capture():
        """An optax stage that keeps the gradients it is given in its
        state: the jitted steps' gradients, read from their output."""
        return optax.GradientTransformation(
            lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))

    cj, ct, plan, (jst0, _, _), tst, batch = t2._setup(3)
    # the jitted steps donate their state: keep host copies
    g0, gs0, d0, ds0 = jax.tree_util.tree_map(np.asarray, (
        jst0.g_params, jst0.g_state, jst0.d_params, jst0.d_state))
    trainable = jpart.split_params(jst0.g_params, plan)[0]
    opt_g = optax.chain(capture(), joptim.clipped_adam(
        jpart.lr_tree_for(trainable, plan), cj.beta1,
        grad_clip=cj.grad_clip))
    opt_d = optax.chain(capture(), joptim.adam(cj.lr_d, cj.beta1))
    jst = JState(jst0.g_params, jst0.g_state, jst0.d_params, jst0.d_state,
                 opt_g.init(trainable), opt_d.init(jst0.d_params), jst0.key)
    real, real_zero, noise_init = (jnp.asarray(a) for a in batch)
    amps = jnp.asarray(t2.AMPS)
    g_apply, d_apply = (jnet.generator_hpvaegan_apply,
                        jnet.wdiscriminator2d_apply)

    # the draws, from the unjitted cores (the same keys as the jitted steps)
    mid_core, _ = jsteps._d_step_core(cj, g_apply, d_apply, opt_d, None)(
        jst, real, noise_init, amps)
    d_draws = [(k, np.asarray(a)) for k, a in drawn]
    d_draws.append(("uniform", np.asarray(jax.random.uniform(
        jax.random.split(jst.key, 3)[2], ()))))
    drawn.clear()
    jsteps._g_step_core(cj, g_apply, d_apply, opt_g, plan, vae_phase=False,
                        cd=None)(mid_core, real, real_zero, noise_init, amps)
    g_draws = [(k, np.asarray(a)) for k, a in drawn]
    assert [k for k, _ in d_draws] == ["normal"] * 3 + ["uniform"]
    assert [k for k, _ in g_draws] == ["normal"] * 4

    # JAX's data-parallel steps over 2 devices
    m = make_mesh(2, data_parallel=2)
    mid, md_j = jsteps.make_d_step(cj, g_apply, d_apply, opt_d, mesh=m)(
        jst, real, noise_init, amps)
    d_grads_j, d_state_j = jax.tree_util.tree_map(
        np.asarray, (mid.opt_d[0], mid.d_state))
    new, mg_j = jsteps.make_g_step(cj, g_apply, d_apply, opt_g, plan,
                                   vae_phase=False, mesh=m)(
        mid, real, real_zero, noise_init, amps)
    g_grads_j = new.opt_g[0]

    def nchw_draws(draws):
        return [torch.from_numpy(np.asarray(a).copy()) if a.ndim == 0
                else nchw(a) for _, a in draws]

    torch.save({"ct": ct, "plan": plan, "n_body": len(tst.G.body),
                "g": tst.G.state_dict(), "d": tst.D.state_dict(),
                "batch": [nchw(a) for a in batch], "amps": list(t2.AMPS),
                "d_draws": nchw_draws(d_draws),
                "g_draws": nchw_draws(g_draws)},
               os.path.join(tmp_path, "step_in.pt"))
    r0, r1 = run_ranks(__file__, "step", tmp_path)

    for part in ("d_grads", "d_sd", "g_grads", "g_sd"):
        for k, v in r0[part].items():
            assert torch.equal(v, r1[part][k]), (part, k)
    assert r0["d_metrics"] == r1["d_metrics"]
    assert r0["g_metrics"] == r1["g_metrics"]
    for got, want in ((r0["d_metrics"], md_j), (r0["g_metrics"], mg_j)):
        t2._metrics_match({k: torch.tensor(v) for k, v in got.items()},
                          want)

    D = port_discriminator(ct, d0, ds0)
    for k, q in D.named_parameters():
        q.grad = r0["d_grads"][k]
    assert_trees_close(port_grads(D, to_jax_discriminator), d_grads_j,
                       **OP_TOL)
    D.load_state_dict(r0["d_sd"])
    assert_trees_close(to_jax_discriminator(D.state_dict())[1], d_state_j,
                       **OP_TOL)
    G = port_generator(ct, g0, gs0)
    for k, q in G.named_parameters():
        q.grad = r0["g_grads"].get(k)
        q.requires_grad_(k in r0["g_grads"])
    t2._g_grads_match(G, plan, g_grads_j, ct.grad_clip)
    G.load_state_dict(r0["g_sd"])
    assert_trees_close(to_jax(G.state_dict())[1], new.g_state, **OP_TOL)


# --------------------------------------------------------- the CLIs ---

def _cli(kind):
    from hpvaegan_tpu_torch import (train_image, train_video,
                                    train_video_baselines)
    from hpvaegan_tpu_torch.training import baselines_trainer, trainer

    if kind.startswith("image"):
        return train_image, trainer
    if kind.startswith("video"):
        return train_video, trainer
    return train_video_baselines, baselines_trainer


def _train(kind, run_dir, extra=()):
    """The `kind` CLI in this process; the trained G's state_dict, its
    amps, the saver's type and experiment dir."""
    cli, trainer = _cli(kind)
    seen = {}
    run = trainer.run_training

    def spy(cfg, saver, **kw):
        G, amps = run(cfg, saver, **kw)
        seen.update(sd={k: v.clone() for k, v in G.state_dict().items()},
                    amps=[float(a) for a in amps],
                    saver=type(saver).__name__, exp=saver.experiment_dir)
        return G, amps

    trainer.run_training = spy
    try:
        exp = cli.main(CLI_ARGS[kind] + COMMON + ["--run-dir", run_dir]
                       + list(extra))
    finally:
        trainer.run_training = run
    assert exp == seen["exp"]
    return seen


def _evaluate(kind, exp, mesh_data):
    """--on-device-fid SIFID (image) or SVFID (video) of 4 samples."""
    from hpvaegan_tpu_torch.evaluation import (eval_image_experiment,
                                               eval_video_experiment,
                                               hydrate_config)

    cfg = hydrate_config(exp, dict(
        niter=1, data_rep=1, batch_size=1, num_samples=4, max_samples=2,
        save_path="images", scale_idx=-1, mesh_data=mesh_data,
        on_device_fid=True, netG=""))
    evaluate = eval_image_experiment if kind.startswith("image") \
        else eval_video_experiment
    return evaluate(cfg, exp, device="cpu")[0]


def _bias_fed_batchnorm(sd):
    """The keys of convolution biases that feed a BatchNorm and of that
    BatchNorm's running mean, which absorbs them. Batch statistics cancel
    such a bias, so its gradient is zero up to rounding, and Adam's update
    turns that rounding into about +-lr (tests/test_torch_trainer.py):
    two runs that sum in another order move these biases apart by ~1e-3
    while the model's function stays the same (`_samples`)."""
    out = set()
    for k in sd:
        block = k[:-len(".conv.bias")]
        if k.endswith(".conv.bias") and f"{block}.norm.weight" in sd:
            out |= {k, f"{block}.norm.running_mean"}
    return out


def _samples(kind, exp):
    """Four samples of the experiment's generator, per-sample BatchNorm
    (where a bias in front of BatchNorm cancels), from seed 3."""
    from hpvaegan_tpu_torch.evaluation import (generate_samples,
                                               hydrate_config,
                                               load_generator)
    from hpvaegan_tpu_torch.utils import pyramid

    cfg = hydrate_config(exp, dict(niter=1, num_samples=4, scale_idx=-1,
                                   netG=""))
    ndim = 2 if kind.startswith("image") else 3
    G = load_generator(cfg, exp, ndim=ndim, device="cpu")[0]
    if kind == "baselines":
        from hpvaegan_tpu_torch.training.baselines_trainer import load_z_init

        G.z_init = load_z_init(exp)
    if ndim == 3:
        cfg.fps, cfg.td, cfg.fps_index = pyramid.get_fps_td_by_index(
            cfg.scale_idx, cfg.stop_scale_time, cfg.sampling_rates,
            cfg.org_fps, cfg.fps_lcm)
    return generate_samples(cfg, G, ndim=ndim, seed=3)


def _case_cli(rank, world, out_dir, kind):
    """One rank of the `kind` CLI's data-parallel run (it joins the group
    itself, from its --dist-* flags), then the 2-rank eval."""
    out = _train(kind, os.path.join(out_dir, "dp"), [
        "--mesh-data", str(world), "--dist-coordinator",
        f"127.0.0.1:{_case_cli.port}", "--dist-nprocs", str(world),
        "--dist-procid", str(rank)])
    out["metric"] = _evaluate(kind, out["exp"], world)
    return out


_case_cli.joins_itself = True


@pytest.mark.parametrize("kind", ["image", "video", "baselines",
                                  "image-paired-flat", "image-fused",
                                  "video-vae-nb"])
def test_data_parallel_cli_equals_one_process(tmp_path, kind,
                                              restore_logging):
    """Two ranks of the `kind` CLI with --mesh-data 2 --batch-size 2 against
    one process with --batch-size 2, then the 2-rank --on-device-fid eval
    against one process's on the same experiment."""
    r0, r1 = run_ranks(__file__, "cli", tmp_path, kind)
    for k, v in r0["sd"].items():
        assert torch.equal(v, r1["sd"][k]), k
    assert r0["amps"] == r1["amps"] and all(a > 0 for a in r0["amps"])
    assert (r0["saver"], r1["saver"]) == ("DataSaver", "NullSaver")
    assert r1["exp"] == r0["exp"]
    exps = glob.glob(os.path.join(tmp_path, "dp", "**", "experiment_*"),
                     recursive=True)
    assert exps == [r0["exp"]]
    n_scales = len(r0["amps"])
    assert n_scales >= 2
    names = os.listdir(r0["exp"])
    for k in range(n_scales):
        assert f"netG_{k}.ckpt" in names
    if kind == "baselines":
        assert "Z_init.npy" in names and f"netD_{n_scales - 1}.ckpt" in names
    with open(os.path.join(r0["exp"], "args.txt")) as f:
        assert "mesh_data: 2" in f.read()

    one = _train(kind, str(tmp_path / "one"))
    assert one["saver"] == "DataSaver"
    np.testing.assert_allclose(r0["amps"], one["amps"], **MULTI_SCALE_TOL)
    absorbed = _bias_fed_batchnorm(one["sd"])
    for k, v in one["sd"].items():
        if k not in absorbed:
            np.testing.assert_allclose(r0["sd"][k].numpy(), v.numpy(),
                                       err_msg=k, **MULTI_SCALE_TOL)
    np.testing.assert_allclose(_samples(kind, r0["exp"]),
                               _samples(kind, one["exp"]), **MULTI_SCALE_TOL)

    assert r0["metric"] == r1["metric"] and np.isfinite(r0["metric"])
    with open(os.path.join(r0["exp"], "eval", "metrics.json")) as f:
        assert json.load(f)["value"] == r0["metric"]
    np.testing.assert_allclose(_evaluate(kind, r0["exp"], 1), r0["metric"],
                               **FID_TOL)


@pytest.fixture
def restore_logging():
    """main() installs its console and logbook handlers on the root logger;
    put pytest's back and close the logbook afterwards."""
    import logging

    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


CASES = {"step": _case_step, "cli": _case_cli}

if __name__ == "__main__":
    worker_main(CASES)
