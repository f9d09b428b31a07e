"""Multi-scale single-image training CLI (the port of the repo's
train_image.py; reference train_image.py:215-274).

    python -m hpvaegan_tpu_torch.train_image \
        --image-path data/imgs/air_balloons.jpg --checkname quick

Runs on the card (cuda:<device-id>) unless `--device cpu` is given. Writes
run/<image>/<checkname>/experiment_<n>/ in the JAX package's format
(args.txt, logbook.txt, netG_<k>.ckpt, netD_<k>.ckpt, intermediate.json),
which the eval CLI of either package evaluates.

Resume a run with --netG and --intermediate (training/trainer.py: from an
inflight_<k>.ckpt, a finalized netG_<k>.ckpt of the port, or reference-style
from any other marker); --ckpt-interval N writes an inflight checkpoint every
N iterations:

    python -m hpvaegan_tpu_torch.train_image --image-path <image> \
        --netG <exp>/inflight_9.ckpt --intermediate <exp>/intermediate.json

The flags are the JAX CLI's, with its defaults, and do what they do
there: --compute-dtype bfloat16 (convolutions and activations in bfloat16,
statistics, latents, losses, parameters and checkpoints in float32),
--fused-dg, --paired-g, --flat-opt, --visualize (images in <exp>/img every
--image-interval iterations) and --profile-dir (a profiler trace of the
run); the JAX package's qualified configuration is

    python -m hpvaegan_tpu_torch.train_image --image-path <image> \
        --compute-dtype bfloat16 --fused-dg

Its XLA knobs are accepted, kept in args.txt and change nothing (they
change no result there either); so is --netD, which the JAX trainer never
reads either.

Multi-process and data-parallel training (parallel/multihost.py,
parallel/mesh.py): one process per card, rank 0 writing the experiment,

    python -m hpvaegan_tpu_torch.train_image --image-path <image> \
        --batch-size N --mesh-data N --dist-coordinator host:port \
        --dist-nprocs N --dist-procid <i>

or `--dist-coordinator auto` under torchrun (cuda:LOCAL_RANK), NCCL with
one card per rank (gloo with --device cpu). --batch-size is the global batch,
which N ranks train as one process does; without --mesh-data every rank
trains the whole batch. --mesh-sp S splits H over S ranks for each data
rank (parallel/spatial.py: halo exchanges, BatchNorm and losses over the
split), on D x S processes in all:

    python -m hpvaegan_tpu_torch.train_image --image-path <image> \
        --batch-size D --mesh-data D --mesh-sp S \
        --dist-coordinator host:port --dist-nprocs <D x S> --dist-procid <i>

which trains as one process does at --batch-size D.
"""

import argparse
import logging
import os
import random

from . import models
from .config import Config
from .parallel import mesh, multihost
from .utils import logger as hlog
from .utils.saver import DataSaver

_NO_EFFECT = "accepted and kept in args.txt; no effect in this port (XLA only)"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--device-id', default=0, type=int, help='Device ID')
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                        help='train on the card (default) or the CPU')

    # Load, input, save configurations
    parser.add_argument('--netG', default='', help='path to netG (to continue training): a netG_<k>.ckpt or an inflight_<k>.ckpt; needs --intermediate')
    parser.add_argument('--netD', default='', help='path to netD (accepted and kept in args.txt; no effect, as in the JAX trainer)')
    parser.add_argument('--intermediate', default='', help="path to the resumed experiment's intermediate.json; needs --netG")
    parser.add_argument('--manualSeed', type=int, help='manual seed')

    # Networks hyper parameters
    parser.add_argument('--nc-im', type=int, default=3, help='# channels')
    parser.add_argument('--nfc', type=int, default=64, help='model basic # channels')
    parser.add_argument('--latent-dim', type=int, default=128, help='Latent dim size')
    parser.add_argument('--vae-levels', type=int, default=3, help='# VAE levels')
    parser.add_argument('--enc-blocks', type=int, default=2, help='# encoder blocks')
    parser.add_argument('--ker-size', type=int, default=3, help='kernel size')
    parser.add_argument('--num-layer', type=int, default=5, help='number of layers')
    parser.add_argument('--stride', default=1, help='stride')
    parser.add_argument('--padd-size', type=int, default=1, help='net pad size')
    parser.add_argument('--generator', type=str, default='GeneratorHPVAEGAN', help='generator model')
    parser.add_argument('--discriminator', type=str, default='WDiscriminator2D', help='discriminator model')

    # Pyramid parameters
    parser.add_argument('--scale-factor', type=float, default=0.75, help='pyramid scale factor')
    parser.add_argument('--noise_amp', type=float, default=0.1, help='addative noise cont weight')
    parser.add_argument('--min-size', type=int, default=32, help='image minimal size at the coarser scale')
    parser.add_argument('--max-size', type=int, default=256, help='image maximal size at the finest scale')

    # Optimization hyper parameters
    parser.add_argument('--niter', type=int, default=5000, help='number of iterations to train per scale')
    parser.add_argument('--lr-g', type=float, default=0.0005, help='G learning rate')
    parser.add_argument('--lr-d', type=float, default=0.0005, help='D learning rate')
    parser.add_argument('--beta1', type=float, default=0.5, help='beta1 for adam')
    parser.add_argument('--lambda-grad', type=float, default=0.1, help='gradient penalty weight')
    parser.add_argument('--rec-weight', type=float, default=10., help='reconstruction loss weight')
    parser.add_argument('--kl-weight', type=float, default=1., help='KL loss weight')
    parser.add_argument('--disc-loss-weight', type=float, default=1.0, help='discriminator weight')
    parser.add_argument('--lr-scale', type=float, default=0.2, help='scaling of learning rate for lower stages')
    parser.add_argument('--train-depth', type=int, default=1, help='how many layers are trained if growing')
    parser.add_argument('--grad-clip', type=float, default=5, help='gradient clip')
    parser.add_argument('--const-amp', action='store_true', default=False, help='constant noise amplitude')
    parser.add_argument('--train-all', action='store_true', default=False, help='train all levels w.r.t. train-depth')

    # Dataset
    parser.add_argument('--image-path', required=True, help='image path')
    parser.add_argument('--hflip', action='store_true', default=False, help='horizontal flip')
    parser.add_argument('--img-size', type=int, default=256)
    parser.add_argument('--stop-scale-time', type=int, default=-1)
    parser.add_argument('--data-rep', type=int, default=1000, help='data repetition')

    # Main arguments
    parser.add_argument('--checkname', type=str, default='debug', help='check name')
    parser.add_argument('--mode', default='train', help='task to be done')
    parser.add_argument('--print-interval', type=int, default=10, help='print interval')
    parser.add_argument('--image-interval', type=int, default=100, help='image interval')
    parser.add_argument('--batch-size', type=int, default=1, help='batch size')
    parser.add_argument('--visualize', action='store_true', default=False, help='write training images to <exp>/img every --image-interval iterations (2D only)')

    # Additions of the JAX package
    parser.add_argument('--compute-dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help='dtype of the convolutions and activations; '
                             'statistics, latents, losses, parameters and '
                             'checkpoints stay float32')
    parser.add_argument('--steps-per-call', type=int, default=8, help=_NO_EFFECT)
    parser.add_argument('--scan-unroll', type=int, default=1, help=_NO_EFFECT)
    parser.add_argument('--compile-ahead', action=argparse.BooleanOptionalAction,
                        default=True, help=_NO_EFFECT)
    parser.add_argument('--split-step', action='store_true', default=False,
                        help=_NO_EFFECT)
    parser.add_argument('--xla-option', dest='xla_options', action='append',
                        default=None, metavar='KEY=VALUE', help=_NO_EFFECT)
    parser.add_argument('--profile-dir', type=str, default='',
                        help='write a torch.profiler trace of the run '
                             '(trace.json) into this dir')
    parser.add_argument('--mesh-data', type=int, default=1,
                        help='data-parallel ranks: the global --batch-size '
                             'splits over them (must equal --dist-nprocs)')
    parser.add_argument('--mesh-sp', type=int, default=1,
                        help='spatial ranks per data rank: H splits over '
                             'them where it divides (--mesh-data x --mesh-sp '
                             'must equal --dist-nprocs)')
    multihost.add_dist_flags(parser)
    parser.add_argument('--paired-g', action='store_true', default=False,
                        help='GAN-phase G step: reconstruction and fake as '
                             'one width-2B forward with per-half BatchNorm '
                             '(exact; 2D GeneratorHPVAEGAN only, no effect '
                             'elsewhere)')
    parser.add_argument('--flat-opt', action='store_true', default=False,
                        help='clip and Adam on one flat buffer (the same '
                             'update)')
    parser.add_argument('--fused-dg', action='store_true', default=False,
                        help='GAN scales: the D and G losses share one fake '
                             'forward (its refinement noise); wins over '
                             '--paired-g')
    parser.add_argument('--ckpt-interval', type=int, default=0,
                        help='write inflight_<k>.ckpt every N iterations '
                             '(0: never)')
    parser.add_argument('--bug-compat', action='store_true', default=False,
                        help='replicate reference bugs (frozen GP alpha, severed '
                             'adv G grad, noise amp /batch_size)')
    parser.add_argument('--run-dir', type=str, default='run', help='experiment root dir')
    return parser


def check_generator(name: str, ndim: int, baselines: bool) -> None:
    """The HP-VAE-GAN CLIs train the registry's other generators, the
    baselines CLI its BASELINES."""
    if name in models.BASELINES and not baselines:
        raise ValueError(f"--generator {name}: a video baseline; python -m "
                         "hpvaegan_tpu_torch.train_video_baselines trains it")
    if baselines and name not in models.BASELINES:
        raise ValueError(f"--generator {name}: train_video_baselines trains "
                         f"{' and '.join(models.BASELINES)}; python -m "
                         "hpvaegan_tpu_torch.train_video trains the others")
    models.get_generator(name, ndim)


def cfg_from_args(args: argparse.Namespace, ndim: int = 2,
                  baselines: bool = False) -> Config:
    if bool(args.netG) != bool(args.intermediate):
        raise SystemExit("--netG and --intermediate go together: a resume "
                         "needs the checkpoint and its experiment's "
                         "intermediate.json")
    check_generator(args.generator, ndim, baselines)
    cfg = Config()
    for k, v in vars(args).items():
        if k == "xla_options" and isinstance(v, list):
            bad = [s for s in v if "=" not in s]
            if bad:
                raise SystemExit(
                    f"--xla-option expects KEY=VALUE, got: {', '.join(bad)}")
            v = dict(s.split("=", 1) for s in v)
        if hasattr(cfg, k):
            setattr(cfg, k, v)
    return cfg


def launch(args: argparse.Namespace, ndim: int, summary,
           trainer=None) -> str:
    """Train from parsed flags (shared by this CLI, train_video's and
    train_video_baselines'): a new experiment dir, its logbook, the
    Experiment Summary (`summary(cfg)` gives its (name, value) lines) and
    the run of `trainer` (a module with run_training: training/trainer.py
    by default, training/baselines_trainer.py for the baselines). Returns
    the dir. --profile-dir traces the run (utils/profiling.py). With the
    --dist-* flags the process joins the run's ranks first and trains from
    the primary's seed; the primary alone makes the dir, the logbook and
    the trace, and every rank returns the dir."""
    from .training import baselines_trainer
    from .training import trainer as hpvaegan_trainer
    from .utils.profiling import trace

    trainer = trainer or hpvaegan_trainer
    cfg = cfg_from_args(args, ndim,
                        baselines=trainer is baselines_trainer).finalize()
    device = mesh.select_device(args.device, args.device_id)
    multihost.init_from_cfg(cfg, device)
    mesh.check_mesh(cfg.mesh_data, cfg.mesh_sp)  # refuse before IO
    if cfg.manualSeed is None:
        cfg.manualSeed = random.randint(1, 10000)
    cfg.manualSeed = multihost.agree_seed(cfg.manualSeed)

    saver = multihost.select_saver(cfg,
                                   lambda: DataSaver(cfg, create=True))
    primary = multihost.is_primary()
    if primary:
        hlog.configure_logging(os.path.abspath(
            os.path.join(saver.experiment_dir, 'logbook.txt')))
        logging.info('Random Seed: %s', cfg.manualSeed)
        with hlog.LoggingBlock('Experiment Summary', emph=True):
            logging.info('Experiment dir: %s', saver.experiment_dir)
            for name, value in summary(cfg) + [('Device', device)]:
                logging.info('%-15s: %s', name, value)
    with trace(args.profile_dir if primary else '', device):
        trainer.run_training(cfg, saver, device=device, seed=cfg.manualSeed,
                             mode="image" if ndim == 2 else "video")
    return saver.experiment_dir


def main(argv=None):
    return launch(build_parser().parse_args(argv), 2, lambda cfg: [
        ('Generator', cfg.generator), ('Iterations', cfg.niter),
        ('Rec. Weight', cfg.rec_weight), ('Scales', cfg.stop_scale + 1)])


if __name__ == '__main__':
    main()
