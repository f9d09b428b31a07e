"""One training iteration: batch, D update (GAN scales), G update.

The port of the JAX package's `training/steps.py` (`_d_step_core`,
`_g_step_core`, `make_calibration`, and the body of `make_train_chunk`) as
the body of a loop whose state is updated in place: training/chunk.py runs
it k times per chunk, replayed from a CUDA graph on one card, so nothing
here reads a value to the host. Gradients come from `torch.autograd.grad`
on the trainable parameters only (D's weights get none in the G step,
whose forward runs D with its parameters out of autograd: `_scores`) and
are left in `.grad` for the optimizer, and for a test to read (G's after
the optimizer's per-tensor clip, which scales them in place).

What each forward keeps of its state, as in the JAX package:
  D step      G's fake under no_grad keeps nothing (steps.py:160); D runs on
              real, fake and the GP's interpolate from the same incoming
              (u, v), and the real pass's new pair is kept (steps.py:169-181)
  G step      the reconstruction folds BatchNorm and advances the encoder's
              (u, v); in the GAN phase the fake folds on top (gs1 -> gs2,
              steps.py:109-127); D runs on the UPDATED D and keeps nothing
  calibration keeps nothing (steps.py:338)

The flag variants of the JAX steps:
  --paired-g  on GAN scales, the G step runs the reconstruction and the
              fake as one forward of width 2B, where the generator has a
              pair (2D GeneratorHPVAEGAN only; steps.py:98-108); no effect
              elsewhere
  --fused-dg  on GAN scales, one iteration is `fused_dg_iteration`
              (steps.py:260-328): one fake forward with grad before the D
              step serves both D (detached) and G's adversarial term, which
              runs on the UPDATED D; G's BatchNorm folds the reconstruction
              and then that fake. It wins over --paired-g (steps.py:214-222)
  --compute-dtype bfloat16  is the modules' (models/blocks.py); the steps
              are the same

Data parallel (--mesh-data N over N ranks, parallel/mesh.py): each rank
forms its rows of the global batch from the same draws (utils/noise.py::
NoiseSource), BatchNorm reduces over the ranks, and `_set_grads` averages
every gradient over them, in one collective, before the optimizer's
per-tensor clip (d_step, g_step, the paired G step and fused_dg_iteration
all set their gradients there; every optimizer, FlatAdam too, takes the
averaged ones). The metrics of an iteration and the calibration's
MSE are the group's means. N ranks thus compute what one process computes
at the global batch, up to the order of float32 sums.

Spatial mesh (--mesh-sp S, parallel/spatial.py): each of those ranks is S
ranks, each holding its rows of H of every activation whose height
divides by S. The discriminator runs `sharded` by the scale's height
(`_d_apply`), the losses are each rank's means (losses.py), and
`_set_grads`, the metrics and the calibration's MSE average over all
D x S ranks, in one collective over both axes. The baselines' critic
scores in a padded layout whose edge ranks hold more rows: `_d_apply`
hands the losses the mean that weighs each rank's share by its rows
(spatial.mean), so that the average over the ranks is still the global
mean.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import torch

from ..data.image import make_image_batch
from ..data.video import make_baseline_batch, make_video_batch
from ..losses import d_loss_fn, g_gan_loss_fn, g_vae_loss_fn
from ..models.blocks import DeferredFolds, assign_sn_state
from ..parallel import mesh, spatial
from ..utils import profiling
from ..utils.pyramid import scale_height
from .state import ScaleTrainState

Metrics = Dict[str, torch.Tensor]
# the phases of an iteration, in order (utils/profiling.py): batch forming;
# G's fake for D; D on real, fake and the interpolate with the gradient
# penalty's first gradient; the critic loss's gradient (the penalty's
# double backward); the gradients' mean over the ranks; the optimizer and
# the spectral-norm state; then G's forward (reconstruction, fake, losses),
# backward, exchange and optimizer; the metrics' mean. The VAE phase runs
# the G phases alone, --fused-dg all but with G's fake taken with grad.
PHASES = ("batch", "d.fake", "d.forward", "d.backward", "d.exchange",
          "d.optim", "g.forward", "g.backward", "g.exchange", "g.optim",
          "metrics")


def _set_grads(params: List[torch.Tensor], loss: torch.Tensor) -> None:
    """The gradients of `loss` into .grad, averaged over all ranks of the
    data and spatial axes (parallel/mesh.py); the phases `.backward` and
    `.exchange` of the step whose forward came before."""
    with profiling.phase(".backward"):
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
    with profiling.phase(".exchange"):
        mesh.mean_(grads, "grad")
    for p, g in zip(params, grads):
        p.grad = g


def _d_apply(cfg, D) -> Tuple[Callable, Callable]:
    """D's forward at scale cfg.scale_idx, and the mean the losses take of
    its scores: on the rank's rows of H where the spatial axis splits the
    scale's height, whose scores are the rank's rows of the layout (H,
    D.score_pad) (0 but for the baselines' critic), weighted by
    spatial.mean."""
    h = scale_height(cfg, cfg.scale_idx)
    if not spatial.sharded(h):
        return D, torch.mean
    layout = spatial.Padded(h, getattr(D, "score_pad", 0))
    return (functools.partial(D, sharded=True),
            lambda t: spatial.mean(t, layout))


def _scores(d_apply: Callable, D) -> Callable:
    """D's scores for G's adversarial term, with D's parameters out of
    autograd while it runs: the G step differentiates G alone, and the
    convolutions of ops/conv.py compute a weight gradient wherever the
    weight requires grad."""
    def scores(x):
        params = [p for p in D.parameters() if p.requires_grad]
        for p in params:
            p.requires_grad_(False)
        try:
            return d_apply(x)[0]
        finally:
            for p in params:
                p.requires_grad_(True)
    return scores


def _detached(loss: torch.Tensor, name: str, aux: Metrics) -> Metrics:
    return {name: loss.detach(), **{k: v.detach() for k, v in aux.items()}}


def d_step(cfg, st: ScaleTrainState, real, noise_init, amps,
           fake=None) -> Metrics:
    """WGAN-GP discriminator update (reference losses.py:17-52,
    train_image.py:157), on `fake` when given (the fused iteration's),
    else on a fake drawn here under no_grad."""
    if fake is None:
        with profiling.phase("d.fake"), torch.no_grad():
            fake = st.G(noise_init, amps, st.noise, bn="batch",
                        commit=False)[0]
    kept = []
    d_apply, score_mean = _d_apply(cfg, st.D)

    def d_fn(x):
        y, sn_state = d_apply(x)
        if not kept:
            kept.append(sn_state)
        return y

    with profiling.phase("d.forward"):
        # one alpha per step; bug_compat freezes it (reference losses.py:26)
        alpha = 0.5 if cfg.bug_compat else st.noise.uniform()
        loss, aux = d_loss_fn(cfg, d_fn, real, fake.detach(), alpha,
                              score_mean)
    _set_grads(list(st.D.parameters()), loss)
    with profiling.phase("d.optim"):
        st.opt_d.step()
        assign_sn_state(st.D, kept[0])
    return _detached(loss, "d_loss", aux)


def _g_update(st: ScaleTrainState, loss, aux) -> Metrics:
    _set_grads([p for g in st.opt_g.param_groups for p in g["params"]], loss)
    with profiling.phase("g.optim"):
        st.opt_g.step()
    return _detached(loss, "g_loss", aux)


def g_step(cfg, st: ScaleTrainState, real, real_zero, noise_init, amps,
           vae_phase: bool) -> Metrics:
    """VAE-phase or GAN-phase generator update (reference losses.py:59-107,
    train_image.py:152-159); the paired forward under cfg.paired_g where G
    has one."""
    pair = None if vae_phase or not cfg.paired_g \
        else getattr(st.G, "reconstruct_pair", None)
    d_apply, score_mean = _d_apply(cfg, st.D)
    with profiling.phase("g.forward"):
        if pair is not None:
            gen, fake = pair(real_zero, noise_init, amps, st.noise)[:2]
            loss, aux = g_gan_loss_fn(cfg, _scores(d_apply, st.D), gen,
                                      real, fake, score_mean)
        else:
            gen, gen_vae, mu, logvar = st.G.reconstruct(real_zero, amps,
                                                        st.noise)
            if vae_phase:
                loss, aux = g_vae_loss_fn(cfg, gen, gen_vae, real, real_zero,
                                          mu, logvar)
            else:
                fake = st.G(noise_init, amps, st.noise, bn="batch")[0]
                loss, aux = g_gan_loss_fn(cfg, _scores(d_apply, st.D), gen,
                                          real, fake, score_mean)
    return _g_update(st, loss, aux)


def fused_dg_iteration(cfg, st: ScaleTrainState, real, real_zero,
                       noise_init, amps) -> Metrics:
    """A GAN-scale iteration under --fused-dg (JAX _fused_dg_step_core):
    one fake forward with grad, its BatchNorm fold deferred; the D step on
    it, detached; the reconstruction (folding BatchNorm, keeping the
    encoder's (u, v)), then the fake's fold; G's adversarial term on the
    updated D. Draws: the fake's noise, the GP alpha, then eps."""
    folds = DeferredFolds()
    with profiling.phase("d.fake"):
        fake = st.G(noise_init, amps, st.noise, bn="batch", commit=folds)[0]
    metrics = d_step(cfg, st, real, noise_init, amps, fake=fake)
    d_apply, score_mean = _d_apply(cfg, st.D)
    with profiling.phase("g.forward"):
        gen = st.G.reconstruct(real_zero, amps, st.noise)[0]
        folds.apply()
        loss, aux = g_gan_loss_fn(cfg, _scores(d_apply, st.D), gen, real,
                                  fake, score_mean)
    metrics.update(_g_update(st, loss, aux))
    return metrics


@torch.no_grad()
def calibrate(G, real, real_zero, amps, noise) -> torch.Tensor:
    """RMSE of the reconstruction against `real` (reference
    train_image.py:134-148), on the device; the MSE is the mean over all
    ranks."""
    gen = G.reconstruct(real_zero, amps, noise, commit=False)[0]
    return torch.sqrt(mesh.mean_([torch.mean((real - gen) ** 2)],
                                 "metric")[0])


def batch_former(ndim: int, scale_idx: int, baseline: bool = False
                 ) -> Callable:
    """The batch former of a 2D or 3D run at `scale_idx` (`baseline`: of a
    CSG/SG run, 3D only): (cfg, data_scale, data_zero, noise) -> (real,
    real_zero, noise_init). What the JAX trainers hand their chunks as
    `batch_body` (trainer.py:133-139, baselines_trainer.py:146 there)."""
    if ndim == 2:
        return make_image_batch
    return functools.partial(make_baseline_batch if baseline
                             else make_video_batch, scale_idx=scale_idx)


def train_iteration(cfg, st: ScaleTrainState, data_scale, data_zero, amps,
                    vae_phase: bool, former: Callable = make_image_batch
                    ) -> Metrics:
    """Batch from `former` (see batch_former), then D (GAN scales only),
    then G against the updated D, or the fused iteration on GAN scales
    under cfg.fused_dg (JAX steps.py:214-245). The D and G steps are the
    same in 2D and 3D. With utils/profiling.py on, the iteration is one
    phases() block (PHASES, those that run)."""
    with profiling.phases(data_scale):
        with profiling.phase("batch"):
            real, real_zero, noise_init = former(cfg, data_scale, data_zero,
                                                 st.noise)
        if cfg.fused_dg and not vae_phase:
            metrics = fused_dg_iteration(cfg, st, real, real_zero,
                                         noise_init, amps)
        else:
            metrics = {}
            if not vae_phase:
                metrics.update(d_step(cfg, st, real, noise_init, amps))
            metrics.update(g_step(cfg, st, real, real_zero, noise_init, amps,
                                  vae_phase))
        with profiling.phase("metrics"):
            return mesh.mean_metrics(metrics)
