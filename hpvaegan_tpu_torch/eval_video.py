"""Video evaluation CLI (the port of the repo's eval_video.py): reload
experiments from args.txt, batch-generate random video samples, write
real_full_scale.npy, random_samples.npy, GIFs and unfold grids, compute
SVFID over C3D block 0.

    python -m hpvaegan_tpu_torch.eval_video --exp-dir "<experiment_dir>" \
        --num-samples 10

Same flags as hpvaegan_tpu_torch.eval_image, `--on-device-fid`,
`--mesh-data` and the --dist-* flags included.
Runs on the card (cuda:<device-id>) unless `--device cpu` is given.
"""

from .eval_image import run
from .evaluation import eval_video_experiment


def main(argv=None):
    run(argv, eval_video_experiment, 'SVFID')


if __name__ == '__main__':
    main()
