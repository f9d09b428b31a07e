"""Post-process for native serving (the port of the repo's postprocess.py):
turn the native runner's output .bins into PNGs and score SIFID against
the trained image; for a video experiment, into (T, H, W, C) uint8 .npy
clips and GIFs, scored by SVFID against the real window.

    python -m hpvaegan_tpu_torch.postprocess --exp-dir <experiment_dir>

Scores on the card unless `--device cpu` is given.
"""

import argparse
import glob
import json
import os

import numpy as np

from .config import Config
from .utils import pyramid
from .utils.saver import resolve_finalized_scale


def _runner_outputs(result_dir: str):
    bins = sorted(glob.glob(os.path.join(result_dir, '*.bin')))
    if not bins:
        raise FileNotFoundError(f'no runner outputs in {result_dir}')
    return bins


def post_process(cfg, exp_dir: str, result_dir: str,
                 save_path: str = 'images') -> str:
    """Each (B, C, H, W) output .bin -> fake_<i>_<j>.png; returns their
    directory."""
    from PIL import Image

    h, w = pyramid.scale_size_2d(cfg.scale_idx, cfg.scale_factor,
                                 cfg.stop_scale, cfg.img_size, cfg.ar)
    out_dir = os.path.join(exp_dir, 'infer', save_path)
    os.makedirs(out_dir, exist_ok=True)
    for i, b in enumerate(_runner_outputs(result_dir)):
        arr = np.fromfile(b, np.float32).reshape(cfg.batch_size, cfg.nc_im,
                                                 h, w)
        img = ((arr.transpose(0, 2, 3, 1) + 1) * 127.5).clip(0, 255)
        for j, im in enumerate(img.astype(np.uint8)):
            Image.fromarray(im).save(os.path.join(out_dir,
                                                  f'fake_{i}_{j}.png'))
    return out_dir


def post_process_video(cfg, exp_dir: str, result_dir: str,
                       save_path: str = 'videos', device='cuda'):
    """Each (B, C, T, H, W) output .bin -> fake_<i>_<j>.npy ((T, H, W, C)
    uint8) and .gif; the real window at the served scale (the frames
    [0 : fps_lcm + 1 : rate]) -> real/real_full_scale.npy. Returns (fake
    dir, real dir)."""
    from .data.video import SingleVideoDataset
    from .utils.media import make_video

    t, h, w = pyramid.scale_size_3d(
        cfg.scale_idx, cfg.scale_factor, cfg.stop_scale, cfg.img_size,
        cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps, cfg.fps_lcm,
        cfg.ar)
    out_dir = os.path.join(exp_dir, 'infer', save_path)
    real_dir = os.path.join(exp_dir, 'infer', 'real')
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(real_dir, exist_ok=True)
    for i, b in enumerate(_runner_outputs(result_dir)):
        arr = np.fromfile(b, np.float32).reshape(cfg.batch_size, cfg.nc_im,
                                                 t, h, w)
        vids = (((arr.transpose(0, 2, 3, 4, 1) + 1) / 2).clip(0, 1)
                * 255).astype(np.uint8)
        for j, v in enumerate(vids):
            np.save(os.path.join(out_dir, f'fake_{i}_{j}.npy'), v)
            make_video(v, 4, os.path.join(out_dir, f'fake_{i}_{j}.gif'))

    cfg.fps, cfg.td, cfg.fps_index = pyramid.get_fps_td_by_index(
        cfg.scale_idx, cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps,
        cfg.fps_lcm)
    frames = SingleVideoDataset(cfg, device).scale_frames(cfg.scale_idx)[0]
    frames = frames.permute(1, 2, 3, 0).cpu().numpy()  # (T, H, W, C)
    window = frames[:cfg.fps_lcm + 1:cfg.sampling_rates[cfg.fps_index]]
    np.save(os.path.join(real_dir, 'real_full_scale.npy'),
            (window * 255).astype(np.uint8))
    return out_dir, real_dir


def main(argv=None):
    from .metrics import calculate_SIFID, calculate_SVFID
    from .utils.device import resolve_device

    parser = argparse.ArgumentParser()
    parser.add_argument('--exp-dir', type=str, required=True)
    parser.add_argument('--result-dir', type=str, default='',
                        help='runner output dir (default '
                             '<exp-dir>/infer/result)')
    parser.add_argument('--device-id', default=0, type=int)
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                        help='score on the card (default) or the CPU')
    parser.add_argument('--scale-idx', type=int, default=-1)
    parser.add_argument('--batch-size', type=int, default=1)
    args = parser.parse_args(argv)
    device = resolve_device(f'cuda:{args.device_id}'
                            if args.device == 'cuda' else 'cpu')

    cfg = Config.from_args_txt(os.path.join(args.exp_dir, 'args.txt'),
                               exceptions=['batch_size', 'scale_idx'])
    cfg.batch_size = args.batch_size
    cfg.scale_idx = args.scale_idx
    if cfg.scale_idx == -1:
        with open(os.path.join(args.exp_dir, 'intermediate.json')) as f:
            inter = json.load(f)
        cfg.scale_idx = resolve_finalized_scale(inter, what='post-process')

    result_dir = args.result_dir or os.path.join(args.exp_dir, 'infer',
                                                 'result')
    if getattr(cfg, 'video_path', ''):
        fake_dir, real_dir = post_process_video(cfg, args.exp_dir,
                                                result_dir, device=device)
        print(f'SVFID: {calculate_SVFID(real_dir, fake_dir, device=device)}')
    else:
        fake_dir = post_process(cfg, args.exp_dir, result_dir)
        # the trained image file: sibling images would pair with the fakes
        sifid = calculate_SIFID(os.path.abspath(cfg.image_path), fake_dir,
                                device=device)
        print(f'SIFID: {sifid}')


if __name__ == '__main__':
    main()
