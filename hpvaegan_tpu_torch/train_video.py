"""Multi-scale single-video training CLI (the port of the repo's
train_video.py; reference train_video.py:215-300).

    python -m hpvaegan_tpu_torch.train_video \
        --video-path data/vids/balloons_pan.avi --checkname quick

Runs on the card (cuda:<device-id>) unless `--device cpu` is given. Writes
run/<clip>/<checkname>/experiment_<n>/ in the JAX package's format
(args.txt with the clip's org_fps, ar and fps_lcm, logbook.txt,
netG_<k>.ckpt, netD_<k>.ckpt, intermediate.json), which the eval_video CLI
of either package evaluates.

The flags are train_image's with --image-path swapped for the video ones,
and the JAX CLI's video defaults (WDiscriminator3D, 50000 iterations,
checkname DEBUG). Resume and the training flags work as in train_image;
`--visualize` is accepted and writes nothing, and `--paired-g` changes
nothing (the JAX package pairs only the 2D generator), as in the JAX
package. GeneratorVAE_nb (the JAX package's 3D one cannot run, so there is
nothing to port it from) raises NotImplementedError; multi-process,
data-parallel and spatial-mesh training (--dist-*, --mesh-data, --mesh-sp,
which splits H, never T) run as in train_image. The CSG/SG baselines train with
train_video_baselines.
"""

import argparse

from . import train_image


def build_parser() -> argparse.ArgumentParser:
    parser = train_image.build_parser()
    # swap the image dataset flag for the video ones
    # (reference train_video.py:276-283)
    for action in list(parser._actions):
        if action.dest == "image_path":
            parser._remove_action(action)
            for group in parser._action_groups:
                if action in group._group_actions:
                    group._group_actions.remove(action)
        elif action.dest == "visualize":
            action.help = "accepted; no effect on video training"
        elif action.dest == "paired_g":
            action.help = "accepted; no effect on video training"
    parser.add_argument('--video-path', required=True, help='video path')
    parser.add_argument('--start-frame', default=0, type=int,
                        help='start frame number')
    parser.add_argument('--max-frames', default=13, type=int,
                        help='# frames to use')
    parser.add_argument('--sampling-rates', type=int, nargs='+',
                        default=[4, 3, 2, 1], help='sampling rates')
    parser.set_defaults(discriminator='WDiscriminator3D', niter=50000,
                        checkname='DEBUG')
    return parser


def summary(cfg):
    """The Experiment Summary's lines of a video run."""
    return [('Start frame', cfg.start_frame), ('Max frames', cfg.max_frames),
            ('Generator', cfg.generator), ('Iterations', cfg.niter),
            ('Sampling rates', cfg.sampling_rates)]


def main(argv=None):
    return train_image.launch(build_parser().parse_args(argv), 3, summary)


if __name__ == '__main__':
    main()
