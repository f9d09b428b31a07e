"""SIFID and SVFID: single-image / single-video Frechet distances over
per-position deep features.

The port of the JAX package's `metrics/fid.py` (reference
src/sinFID/fid_score.py:36-242): per (real, fake) pair, the Frechet distance
between the Gaussians of block features taken over every spatial (and
temporal) position, InceptionV3 block 0 for images and C3D for videos.
Features run on the given device, the card unless the caller asks for the
CPU; the Frechet math (scipy sqrtm, 64x64 covariances) stays on the host in
float64.
"""

from __future__ import annotations

import pathlib
import warnings
from typing import List, Optional

import numpy as np
import torch
from scipy import linalg

from .c3d import C3D
from .inception import InceptionV3


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """Frechet distance between two Gaussians (reference fid_score.py:105-159,
    the standard numpy implementation)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"mismatched statistics: {mu1.shape} vs {mu2.shape}, "
                         f"{sigma1.shape} vs {sigma2.shape}")
    diff = mu1 - mu2
    # near-singular products are expected (fewer positions than channels)
    # and handled by the eps-offset retry below
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Matrix is singular")
        covmean = np.asarray(linalg.sqrtm(sigma1.dot(sigma2)))
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = np.asarray(
                linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset)))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("Imaginary component {}".format(
                np.max(np.abs(covmean.imag))))
        covmean = covmean.real
    return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
            - 2 * np.trace(covmean))


def _positionwise_stats(feats: torch.Tensor):
    """(B, C, H, W) or (B, C, T, H, W) features -> (mu, sigma) over all
    positions (fid_score.py:96-97, 162-180)."""
    act = feats.movedim(1, -1).reshape(-1, feats.shape[1])
    act = act.cpu().numpy().astype(np.float64)
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def _pairwise(model, block: int, reals: np.ndarray, fakes: np.ndarray
              ) -> List[float]:
    """Frechet distance of each fake's block features to its real's,
    channels-last arrays in; fake i pairs with real min(i, N_real - 1)
    (fid_score.py:198-203)."""
    def feats(a):
        x = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return model(x.movedim(-1, 0)[None])[block]

    vals = []
    for i in range(len(fakes)):
        m1, s1 = _positionwise_stats(feats(reals[min(i, len(reals) - 1)]))
        m2, s2 = _positionwise_stats(feats(fakes[i]))
        vals.append(float(calculate_frechet_distance(m2, s2, m1, s1)))
    return vals


def _block(model, dims: int) -> int:
    """The position of the `dims` block in `model`'s outputs: a model
    built with more output blocks puts it elsewhere than last (JAX
    fid.py::_block_out)."""
    return model.output_blocks.index(model.BLOCK_INDEX_BY_DIM[dims])


def sifid_arrays(reals: np.ndarray, fakes: np.ndarray, dims: int = 64,
                 model: Optional[InceptionV3] = None,
                 weights: Optional[str] = None, device="cuda") -> List[float]:
    """Per-pair SIFID. reals/fakes: (N, H, W, 3) float in [0, 1]."""
    model = model or InceptionV3([InceptionV3.BLOCK_INDEX_BY_DIM[dims]],
                                 weights=weights, device=device)
    return _pairwise(model, _block(model, dims), reals, fakes)


def svfid_arrays(reals: np.ndarray, fakes: np.ndarray, dims: int = 64,
                 model: Optional[C3D] = None, weights: Optional[str] = None,
                 device="cuda") -> List[float]:
    """Per-pair SVFID. reals/fakes: (N, T, H, W, 3) float in [0, 1]."""
    model = model or C3D([C3D.BLOCK_INDEX_BY_DIM[dims]], weights=weights,
                         device=device)
    return _pairwise(model, _block(model, dims), reals, fakes)


def _load_images(files) -> np.ndarray:
    from PIL import Image

    imgs = []
    for f in files:
        with Image.open(str(f)) as im:
            if im.mode not in ("RGB", "RGBA", "L"):
                im = im.convert("RGB")
            img = np.asarray(im).astype(np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        imgs.append(img[..., :3] / 255.0)
    return np.stack(imgs)


def calculate_SIFID(real_dir: str, fake_dir: str, dims: int = 64,
                    suffix: str = "png",
                    weights: Optional[str] = None, device="cuda") -> float:
    """Directory-level SIFID (reference fid_score.py:183-211: reals glob
    *.jpg, fakes glob *.<suffix>). real_dir may also be a single image file:
    eval scores against the one trained image."""
    real_path = pathlib.Path(real_dir)
    if real_path.is_file():
        real_files = [real_path]
    else:
        real_files = sorted(real_path.glob("*.jpg")) or \
            sorted(real_path.glob("*.png"))
    fake_files = sorted(pathlib.Path(fake_dir).glob(f"*.{suffix}"))
    if not real_files or not fake_files:
        raise FileNotFoundError(f"no images to score: {real_dir!r} has "
                                f"{len(real_files)}, {fake_dir!r} has "
                                f"{len(fake_files)}")
    model = InceptionV3([InceptionV3.BLOCK_INDEX_BY_DIM[dims]],
                        weights=weights, device=device)
    vals = []
    for i, fake in enumerate(fake_files):
        reals = _load_images([real_files[min(i, len(real_files) - 1)]])
        fakes = _load_images([fake])
        if reals.shape != fakes.shape:
            # the per-pair metric needs one grid: crop both to the top-left
            # overlap (where the pyramid anchors content)
            h = min(reals.shape[1], fakes.shape[1])
            w = min(reals.shape[2], fakes.shape[2])
            reals, fakes = reals[:, :h, :w], fakes[:, :h, :w]
        vals.extend(sifid_arrays(reals, fakes, dims, model=model))
    return float(np.asarray(vals, np.float32).mean())


def calculate_SVFID(real_dir: str, fake_dir: str, dims: int = 64,
                    suffix: str = "npy", weights: Optional[str] = None,
                    device="cuda") -> float:
    """Directory-level SVFID over .npy videos (T, H, W, C), uint8 or float
    in [0, 1] or [0, 255]; each pair is cropped to its common (t, h, w)."""
    real_files = sorted(pathlib.Path(real_dir).glob(f"*.{suffix}"))
    fake_files = sorted(pathlib.Path(fake_dir).glob(f"*.{suffix}"))
    if not real_files or not fake_files:
        raise FileNotFoundError(f"no videos to score: {real_dir!r} has "
                                f"{len(real_files)}, {fake_dir!r} has "
                                f"{len(fake_files)}")

    def load(f):
        raw = np.load(str(f))
        arr = raw.astype(np.float32)
        # the dtype decides for uint8 (a near-black clip has max <= 1)
        if raw.dtype == np.uint8 or arr.max() > 1.5:
            arr = arr / 255.0
        return arr

    model = C3D([C3D.BLOCK_INDEX_BY_DIM[dims]], weights=weights, device=device)
    vals = []
    for i, fake in enumerate(fake_files):
        r = load(real_files[min(i, len(real_files) - 1)])
        f = load(fake)
        t, h, w = (min(a, b) for a, b in zip(r.shape[:3], f.shape[:3]))
        vals.extend(svfid_arrays(r[None, :t, :h, :w], f[None, :t, :h, :w],
                                 dims, model=model))
    return float(np.asarray(vals, np.float32).mean())
