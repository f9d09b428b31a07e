"""Losses: KL (Gaussian and Bernoulli), WGAN-GP discriminator loss, VAE- and GAN-phase generator loss.

The port of the JAX package's `losses.py` (reference src/modules/losses.py:
5-107). Every term is f32, also when activations flow in bfloat16
(losses.py:37-91 there). The gradient penalty's inner gradient is
`torch.autograd.grad(..., create_graph=True)`, so the outer backward runs
through it (the double backward).

Reference bugs, as in the JAX package: the GP alpha is drawn per step by the
caller (cfg.bug_compat freezes it to 0.5 there), and the adversarial G term
reaches the generator unless cfg.bug_compat detaches the fake
(reference losses.py:94).

Over ranks (--mesh-data, --mesh-sp; parallel/mesh.py) every mean here is
the rank's own: the mean over its rows of the batch and, where the
spatial axis splits H, over its rows of H. training/steps.py averages the
gradients and metrics over all D x S ranks, which makes them the global
means': the shards are equal (H is split only where it divides), and a
term of a replicated activation is the same on every spatial rank. The
gradient penalty's per-pixel channel norm is local, and the gradient it
takes the norm of is the global one: the halo exchanges' adjoints
(parallel/spatial.py) add to each rank's rows what its neighbours' outputs
owe them. The critic's scores are meaned by `score_mean`, which the
caller hands over: torch.mean, or for the baselines' critic under a
spatial axis, whose scores' shards are unequal, spatial.mean, which
weighs each rank's share by its rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

Metrics = Dict[str, torch.Tensor]


def kl_criterion(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, 1)), mean-reduced (reference losses.py:5-7)."""
    return torch.mean(-0.5 * (1 + logvar - mu.pow(2) - torch.exp(logvar)))


def kl_bern_criterion(x: torch.Tensor) -> torch.Tensor:
    """Bernoulli KL against p = 0.5, mean-reduced (reference losses.py:10-14;
    the JAX package's steps do not call it either)."""
    log_half = torch.log(torch.tensor(0.5, dtype=x.dtype))
    return torch.mean(x * (torch.log(x + 1e-20) - log_half)
                      + (1 - x) * (torch.log(1 - x + 1e-20) - log_half))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


def gradient_penalty(d_apply: Callable, real: torch.Tensor,
                     fake: torch.Tensor, alpha, lam: float) -> torch.Tensor:
    """WGAN-GP (reference losses.py:47-52) with the reference's per-CHANNEL
    gradient norm (dim 1 of NCHW; the JAX package's axis -1 of NHWC). The
    interpolate is float32 whatever the fake's dtype: JAX promotes its
    float32 alpha with a bfloat16 fake to float32, where PyTorch's rules
    would keep a zero-dim alpha's product in bfloat16."""
    interp = (alpha * real + (1 - alpha) * fake.float()).requires_grad_(True)
    grads, = torch.autograd.grad(d_apply(interp).float().sum(), interp,
                                 create_graph=True)
    norms = torch.sqrt(torch.sum(grads.float() ** 2, dim=1) + 1e-12)
    return torch.mean((norms - 1) ** 2) * lam


def d_loss_fn(cfg, d_apply: Callable, real: torch.Tensor, fake: torch.Tensor,
              alpha, score_mean: Callable = torch.mean
              ) -> Tuple[torch.Tensor, Metrics]:
    """-E[D(real)] + E[D(fake)] + GP (reference losses.py:27-45); `fake` is
    detached by the caller. Applies `d_apply` to `real` FIRST: the D step
    keeps the spectral-norm state of that application."""
    err_real = -score_mean(d_apply(real).float())
    err_fake = score_mean(d_apply(fake).float())
    gp = gradient_penalty(d_apply, real, fake, alpha, cfg.lambda_grad)
    return err_real + err_fake + gp, {"d_real": -err_real, "d_fake": err_fake,
                                      "gp": gp}


def g_vae_loss_fn(cfg, generated, generated_vae, real, real_zero, mu,
                  logvar) -> Tuple[torch.Tensor, Metrics]:
    """VAE-phase G loss (reference losses.py:79-85)."""
    rec = mse(generated, real) + mse(generated_vae, real_zero)
    kl = kl_criterion(mu, logvar)
    return cfg.rec_weight * rec + cfg.kl_weight * kl, {"rec": rec, "kl": kl}


def g_gan_loss_fn(cfg, d_apply: Callable, generated, real, fake,
                  score_mean: Callable = torch.mean
                  ) -> Tuple[torch.Tensor, Metrics]:
    """GAN-phase G loss: reconstruction + adversarial (reference
    losses.py:87-101)."""
    rec = mse(generated, real)
    if cfg.bug_compat:
        fake = fake.detach()  # reference losses.py:94
    adv = -score_mean(d_apply(fake).float()) * cfg.disc_loss_weight
    return cfg.rec_weight * rec + adv, {"rec": rec, "adv": adv}
