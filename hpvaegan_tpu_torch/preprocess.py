"""Pre-process for native serving (the port of the repo's preprocess.py):
write the noise_init / noise_amps / seed .bin inputs of the native runner
into <exp-dir>/infer/.

    python -m hpvaegan_tpu_torch.preprocess --exp-dir <experiment_dir> \
        [--num-samples N] [--seed S] [--batch-size B]

The bins are byte for byte the JAX package's for the same experiment,
seed, batch size and sample count (numpy's RandomState draws them).
"""

import argparse
import json
import os

import numpy as np

from .config import Config
from .utils import pyramid
from .utils.saver import resolve_finalized_scale


def pre_process(cfg, exp_dir: str, seed: int = 0, num_samples: int = 1):
    """Write infer/{noise_init,noise_amps,seed}/*.bin: NCHW (NCTHW)
    float32 noise at scale 0 (the time depth of scale 0 in 3D), the amps
    padded with zeros to stop_scale + 2, the int32 seed. num_samples > 1
    writes one noise bin per sample (the runner runs once per file). Stale
    noise and result bins are removed first. cfg.scale_idx == -1 resolves
    to the last finalized scale. Returns (the first noise draw, amps)."""
    infer_dir = os.path.join(exp_dir, "infer")
    os.makedirs(infer_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "intermediate.json")) as f:
        inter = json.load(f)
    if cfg.scale_idx == -1:
        cfg.scale_idx = resolve_finalized_scale(inter, what="serve")
    amps = np.zeros((cfg.stop_scale + 2,), np.float32)
    vals = inter["noise_amps"][:cfg.scale_idx + 1]
    amps[:len(vals)] = vals

    h0, w0 = pyramid.scale_size_2d(0, cfg.scale_factor, cfg.stop_scale,
                                   cfg.img_size, cfg.ar)
    rng = np.random.RandomState(seed)
    if getattr(cfg, "video_path", ""):
        _, td0, _ = pyramid.get_fps_td_by_index(
            0, cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps,
            cfg.fps_lcm)
        shape = (cfg.batch_size, cfg.latent_dim, td0, h0, w0)
    else:
        shape = (cfg.batch_size, cfg.latent_dim, h0, w0)
    for sub in ("noise_init", "noise_amps", "seed"):
        os.makedirs(os.path.join(infer_dir, sub), exist_ok=True)
    for sub in ("noise_init", "result"):
        d = os.path.join(infer_dir, sub)
        if os.path.isdir(d):
            for old in os.listdir(d):
                if old.endswith(".bin"):
                    os.remove(os.path.join(d, old))
    noise_init = None
    for i in range(max(1, num_samples)):
        draw = rng.standard_normal(shape).astype(np.float32)
        noise_init = draw if noise_init is None else noise_init
        name = "noise_init.bin" if num_samples <= 1 \
            else f"noise_init_{i:03d}.bin"
        draw.tofile(os.path.join(infer_dir, "noise_init", name))
    amps.tofile(os.path.join(infer_dir, "noise_amps", "noise_amps.bin"))
    np.asarray(seed, np.int32).tofile(os.path.join(infer_dir, "seed",
                                                   "seed.bin"))
    return noise_init, amps


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--exp-dir', type=str, required=True,
                        help='Experiment directory')
    parser.add_argument('--scale-idx', type=int, default=-1,
                        help='scale to serve (-1: the last finalized)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--num-samples', type=int, default=1,
                        help='noise bins to write (the runner runs one '
                             'inference per bin and averages latency)')
    parser.add_argument('--batch-size', type=int, default=1,
                        help="must match the export's --batch-size (the "
                             "runner checks bin bytes against io_spec.txt)")
    args = parser.parse_args(argv)

    cfg = Config.from_args_txt(os.path.join(args.exp_dir, 'args.txt'))
    cfg.batch_size = args.batch_size
    cfg.scale_idx = args.scale_idx
    pre_process(cfg, args.exp_dir, seed=args.seed,
                num_samples=args.num_samples)
    print(f'wrote {os.path.join(args.exp_dir, "infer")}')


if __name__ == '__main__':
    main()
