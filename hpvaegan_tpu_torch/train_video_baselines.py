"""SinGAN-style video baselines training CLI (the port of the repo's
train_video_baselines.py; reference train_video_baselines.py:326-360).

    python -m hpvaegan_tpu_torch.train_video_baselines \
        --video-path data/vids/balloons_pan.avi --checkname quick

Trains GeneratorCSG (the default) or GeneratorSG against
WDiscriminatorBaselines: a GAN at every scale with a fixed Z_init
reconstruction noise (training/baselines_trainer.py). The flags are
train_video's; HP-VAE-GAN generators are refused (train_video trains them).
Runs on the card (cuda:<device-id>) unless `--device cpu` is given. Writes
run/<clip>/<checkname>/experiment_<n>/ in the JAX package's format
(args.txt, logbook.txt, netG_<k>.ckpt and netD_<k>.ckpt at every scale,
Z_init.npy, intermediate.json), which the eval_video CLI of either package
evaluates. --netG / --intermediate / --ckpt-interval resume as in
train_image; --compute-dtype bfloat16, --fused-dg, --flat-opt and
--profile-dir work as there (--paired-g and --visualize change nothing, as
in the JAX baselines trainer), and so do --dist-*, --mesh-data and
--mesh-sp: with --mesh-sp S each data rank is S ranks that split H
wherever a scale's height divides by S (the padded stages' edge ranks
hold their pad rows, models/networks_3d.py), and D x S ranks train what
one process trains at --batch-size D.
"""

from . import train_image, train_video


def build_parser():
    parser = train_video.build_parser()
    parser.set_defaults(generator='GeneratorCSG',
                        discriminator='WDiscriminatorBaselines')
    return parser


def main(argv=None):
    from .training import baselines_trainer

    return train_image.launch(build_parser().parse_args(argv), 3,
                              train_video.summary, trainer=baselines_trainer)


if __name__ == '__main__':
    main()
