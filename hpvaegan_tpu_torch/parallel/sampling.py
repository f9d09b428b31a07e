"""Batched sample generation on one device, and SIFID / SVFID computed
beside it on the device.

The port of the JAX package's `parallel/sampling.py`: `sharded_sampler` and
the on-device metrics `make_sampled_sifid` / `make_sampled_svfid`. BASELINE
config 5 is batched diverse-sample generation at 64 samples a batch with
on-device SIFID; the reference generates one sample per generator call
(eval_image.py:54-61) and scores PNG files.

Over a data group of N ranks (parallel/mesh.py, the group in force) each
rank generates its share of the num_samples, which N must divide (JAX
:90-93): rows [rank * n, (rank + 1) * n) of them, n = num_samples / N,
from its rows of the global draws (z, the refinement noise, and in
moving-stat mode K1's per-sample seeds, offset by the rank's first row in
each forward), so that N ranks x n make what one process makes at
num_samples, sub-batches included (below). The on-device metrics gather
the packed per-sample statistics and the kept samples to every rank in
one all_gather (multihost.to_host), and every rank computes the same
Frechet distances.

A batch whose widest activation would hold 2^31 elements (8.6 GB of
float32) or more runs as equal sub-batches, one forward each, to bound the
peak memory: one full-width video sample's last stage holds 64 channels x
13 x 192 x 257 = 41M elements, so 64 samples make 10.5 GB activations, about
four of them alive at once. On an H100 two sub-batches of 32 peak at 22 GB
where one forward of 64 peaks at 44 GB and is no faster (PERF.md). A CSG/SG
baseline's widest activation is at its last stage's size padded by
num_layer + 1 per side, 64 x 25 x 204 x 269 = 87.8M elements at full
width, so 64 samples run as 21 / 21 / 22. The split is exact in both
sampler modes (neither reads batch statistics); it changes only the order
of the refinement noise draws. A data group keeps one process's split of
num_samples, and so its draws: each rank runs each sub-batch on its rows
in it, and on none where it has none, to make the sub-batch's draws
(`batches`).
"""

from __future__ import annotations

import math
import warnings
from typing import List, Tuple

import numpy as np
import torch

from ..utils import profiling, pyramid
from ..utils.noise import NoiseSource
from . import mesh, multihost

MAX_ELEMENTS = 2 ** 31 - 1  # per activation tensor of one forward


def _sample_elements(cfg, ndim: int, scale: int, z_tail, pad: int = 0
                     ) -> int:
    """Elements of one sample's widest activation: nfc channels at the size
    of pyramid scale `scale` (the last stage's) padded by `pad` per side,
    or at z's size when that is larger."""
    sizes = [math.prod(z_tail[:-1])]
    if scale or pad:
        if ndim == 2:
            size = pyramid.scale_size_2d(scale, cfg.scale_factor,
                                         cfg.stop_scale, cfg.img_size, cfg.ar)
        else:
            size = pyramid.scale_size_3d(
                scale, cfg.scale_factor, cfg.stop_scale, cfg.img_size,
                cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps,
                cfg.fps_lcm, cfg.ar)
        sizes.append(math.prod(s + 2 * pad for s in size))
    return int(cfg.nfc) * max(sizes)


def generator_elements(cfg, generator, ndim: int, z_tail) -> int:
    """_sample_elements of `generator` at its stage count."""
    return _sample_elements(cfg, ndim,
                            len(generator.body) - generator.body_offset,
                            z_tail, generator.widest_pad)


def sub_batches(num_samples: int, per_sample: int) -> list:
    """Equal [start, stop) ranges that keep each forward's widest activation
    under MAX_ELEMENTS."""
    most = max(1, MAX_ELEMENTS // per_sample)
    n = -(-num_samples // most)
    bounds = [num_samples * i // n for i in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def sharded_sampler(cfg, generator, ndim: int = 2, train: bool = True,
                    z_tail=None):
    """Returns sample(num_samples, noise) -> (N, C, H, W) tensor (in 3D
    (N, C, T, H, W)) in [-1, 1] on the generator's device: under a data
    group, this rank's N = num_samples / group size rows.

    train=True (default) normalises with per-sample statistics (BatchNorm
    mode "sample"): one batched forward equal to the JAX sampler's vmap of
    batch-1 train-mode forwards, which matches the reference's eval — it
    never leaves the training phase and generates one sample per call.
    train=False is the plain batched forward on the moving statistics; with
    cfg.pallas_fused_sampling its 2D refinement stages run the fused
    upscale+noise kernel (3D has none).

    z_tail: the per-sample latent shape, channels-last as the JAX package
    gives it: (h0, w0, latent_dim) by default in 2D, (td0, h0, w0,
    latent_dim) in 3D (a baseline's: evaluation.eval_z_tail); z is drawn
    channels-first.
    """
    if ndim not in (2, 3):
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    if z_tail is None:
        h0, w0 = pyramid.scale_size_2d(0, cfg.scale_factor, cfg.stop_scale,
                                       cfg.img_size, cfg.ar)
        z_tail = (h0, w0, cfg.latent_dim)
        if ndim == 3:
            _, td0, _ = pyramid.get_fps_td_by_index(
                0, cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps,
                cfg.fps_lcm)
            z_tail = (td0,) + z_tail
    z_tail = tuple(z_tail)
    per_sample = generator_elements(cfg, generator, ndim, z_tail)

    amps = np.zeros((cfg.stop_scale + 2,), np.float32)
    amps[:len(cfg.Noise_Amps)] = cfg.Noise_Amps
    bn = "sample" if train else "moving"

    def batches(num_samples: int, noise: NoiseSource):
        """The samples of sample(num_samples, noise), one tensor per
        sub-batch, each made when the caller asks for it. The sub-batches
        are one process's, over all num_samples: under a data group each
        rank runs every one of them on its rows in it, none for some, from
        the draws one process makes for it (`noise.window`)."""
        local = mesh.local_rows(num_samples)
        first = mesh.active().rank * local
        z = noise.normal((local, z_tail[-1]) + z_tail[:-1])
        for a, b in sub_batches(num_samples, per_sample):
            lo, hi = max(a, first), min(b, first + local)
            if hi <= lo:  # no rows here: a forward of none, for the draws
                with torch.no_grad(), noise.window(b - a, 0), \
                        warnings.catch_warnings():
                    # per-sample statistics of no sample
                    warnings.simplefilter("ignore", UserWarning)
                    generator(z[:0], amps, noise, bn=bn)
                continue
            with torch.no_grad(), noise.window(b - a, lo - a):
                yield generator(z[lo - first:hi - first], amps, noise,
                                bn=bn)[0]

    def sample(num_samples: int, noise: NoiseSource) -> torch.Tensor:
        outs = list(batches(num_samples, noise))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    sample.batches = batches
    return sample


def _per_sample_stats(feats: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, *positions) features -> per-sample mu (B, C) and sigma
    (B, C, C), float32, sigma = centered^T centered / (n - 1) over the
    positions (JAX parallel/sampling.py:103-112)."""
    b, c = feats.shape[:2]
    flat = feats.reshape(b, c, -1).float()
    mu = flat.mean(dim=2)
    centered = flat - mu[:, :, None]
    sigma = torch.bmm(centered, centered.transpose(1, 2)) \
        / (flat.shape[2] - 1)
    return mu, sigma


def _feature_stats(model, block: int, x01: torch.Tensor) -> torch.Tensor:
    """Per-sample (mu, sigma) of `model`'s output `block` for inputs in
    [0, 1], packed as one (B, C, C + 1) tensor on the device: mu in column
    0, sigma after it."""
    mu, sigma = _per_sample_stats(model(x01)[block])
    return torch.cat([mu[:, :, None], sigma], dim=2)


def _pinned_blocks() -> int:
    """Pinned blocks PyTorch's caching host allocator has made so far."""
    return torch.cuda.host_memory_stats().get("num_host_alloc", 0)


def _host_copy(*ts: torch.Tensor) -> np.ndarray:
    """The one copy of a run's result to the host: ts, of one trailing
    shape, joined along their first dimension in one C-contiguous array,
    in the device phase "d2h" (utils/profiling.py), with its bytes on the
    counter "d2h_bytes".

    From a CUDA device each tensor is made contiguous there and copied
    once, without blocking, into its rows of one pinned buffer from
    PyTorch's caching host allocator; the phase ends when the copies
    have. The array holds the buffer, which goes back to the allocator's
    cache when the array goes, so that a loop that drops its results
    copies into one block, already faulted in, every time. On the card the
    counter "d2h_pinned_bytes" takes the bytes too, and "d2h_host_allocs"
    the blocks the allocator newly made for them. On the CPU one tensor is
    made contiguous and copied no further."""
    first = ts[0]
    cuda = first.device.type == "cuda"
    blocks = _pinned_blocks() if cuda and profiling.enabled() else None
    with profiling.phase("d2h", first.device):
        if len(ts) == 1 and not cuda:
            host = first.contiguous()
        else:
            host = torch.empty((sum(len(t) for t in ts),) + first.shape[1:],
                               dtype=first.dtype, pin_memory=cuda)
            for rows, t in zip(host.split([len(t) for t in ts]), ts):
                rows.copy_(t.contiguous() if cuda else t, non_blocking=cuda)
            if cuda:
                torch.cuda.current_stream(first.device).synchronize()
    nbytes = host.numel() * host.element_size()
    profiling.count("d2h_bytes", nbytes)
    if blocks is not None:
        profiling.count("d2h_pinned_bytes", nbytes)
        profiling.count("d2h_host_allocs", _pinned_blocks() - blocks)
    return host.numpy()


def group_to_host(*ts: torch.Tensor):
    """A run's results on the host: one copy each on one rank; over a data
    group, this rank's rows of each, gathered to every rank in one
    all_gather."""
    if mesh.active().group is not None:
        return multihost.to_host(ts)
    return tuple(_host_copy(t) for t in ts)


def _frechet(stats: np.ndarray, real: np.ndarray) -> List[float]:
    """Frechet distance of each packed per-sample (mu, sigma) to the real
    one's, on the host (scipy sqrtm)."""
    from ..metrics.fid import calculate_frechet_distance

    return [float(calculate_frechet_distance(s[:, 0], s[:, 1:],
                                             real[:, 0], real[:, 1:]))
            for s in stats]


def _sampled_fid(cfg, generator, real01: np.ndarray, ndim: int, model,
                 dims: int, z_tail):
    """run(num_samples, noise, return_samples=0) for the 2D or 3D sampler
    of `generator` (per-sample BatchNorm, as the CLIs sample) and `model`
    (InceptionV3 or C3D with the block of `dims`). real01: (H, W, 3), in
    3D (T, H, W, 3), float in [0, 1]."""
    from ..metrics.fid import _block
    from ..ops.resize import resize_bilinear, resize_trilinear

    sample = sharded_sampler(cfg, generator, ndim=ndim, z_tail=z_tail)
    block = _block(model, dims)
    device = next(generator.parameters()).device
    real = torch.from_numpy(np.ascontiguousarray(real01, np.float32))
    real = real.movedim(-1, 0)[None].to(device)
    real_stats: List[np.ndarray] = []  # computed once, at the fakes' size

    def run(num_samples: int, noise: NoiseSource, return_samples: int = 0):
        stats, kept = [], []
        k = min(return_samples, num_samples)
        # each rank keeps its first rows; the first k of the gathered rows
        # are the global batch's first k
        k_local = min(k, mesh.local_rows(num_samples))
        for fakes in sample.batches(num_samples, noise):
            stats.append(_feature_stats(model, block, (fakes + 1.0) * 0.5))
            if not real_stats:
                resize = resize_bilinear if ndim == 2 else resize_trilinear
                size = fakes.shape[2:]
                real_stats.append(_host_copy(_feature_stats(
                    model, block, resize(real, size, align_corners=False)))[0])
            left = k_local - sum(len(f) for f in kept)
            if left > 0:  # a copy, so that the sub-batch can go
                kept.append(fakes[:left].clone())
        if return_samples:
            host_stats, host_kept = group_to_host(torch.cat(stats),
                                             torch.cat(kept).movedim(1, -1))
            return _frechet(host_stats, real_stats[0]), host_kept[:k]
        return _frechet(group_to_host(torch.cat(stats))[0], real_stats[0])

    return run


def make_sampled_sifid(cfg, generator, real_image: np.ndarray,
                       dims: int = 64, z_tail=None):
    """Batched diverse-sample generation with on-device SIFID (BASELINE
    config 5; JAX parallel/sampling.py:115-167). Returns run(num_samples,
    noise, return_samples=0) -> per-sample SIFIDs.

    Samples and Inception block features stay on the generator's device,
    one sampler sub-batch at a time (the statistics are per sample, so the
    split is exact); only the per-sample (mu, sigma) go to the host, in one
    copy, for the Frechet sqrtm. The real image's statistics are computed
    once, at the fakes' size (bilinear, half-pixel). With return_samples=k,
    run also copies the first k samples to the host and returns (vals,
    samples (k, H, W, 3) in [-1, 1])."""
    from ..metrics.inception import InceptionV3

    model = InceptionV3([InceptionV3.BLOCK_INDEX_BY_DIM[dims]],
                        device=next(generator.parameters()).device)
    return _sampled_fid(cfg, generator, real_image, 2, model, dims, z_tail)


def sampled_sifid(cfg, generator, real_image: np.ndarray, num_samples: int,
                  noise: NoiseSource, dims: int = 64, z_tail=None,
                  return_samples: int = 0):
    """One-shot make_sampled_sifid."""
    return make_sampled_sifid(cfg, generator, real_image, dims, z_tail)(
        num_samples, noise, return_samples)


def make_sampled_svfid(cfg, generator, real_video: np.ndarray,
                       dims: int = 64, z_tail=None):
    """make_sampled_sifid for videos (JAX parallel/sampling.py:170-214):
    C3D block features, the real clip (T, H, W, 3) resized trilinearly to
    the fakes' size; return_samples gives (k, T, H, W, 3)."""
    from ..metrics.c3d import C3D

    model = C3D([C3D.BLOCK_INDEX_BY_DIM[dims]],
                device=next(generator.parameters()).device)
    return _sampled_fid(cfg, generator, real_video, 3, model, dims, z_tail)


def sampled_svfid(cfg, generator, real_video: np.ndarray, num_samples: int,
                  noise: NoiseSource, dims: int = 64, z_tail=None,
                  return_samples: int = 0):
    """One-shot make_sampled_svfid."""
    return make_sampled_svfid(cfg, generator, real_video, dims, z_tail)(
        num_samples, noise, return_samples)
