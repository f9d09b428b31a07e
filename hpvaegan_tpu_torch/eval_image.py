"""Image evaluation CLI (the port of the repo's eval_image.py): reload
experiments from args.txt, batch-generate random samples, dump PNGs,
compute SIFID.

    python -m hpvaegan_tpu_torch.eval_image --exp-dir "<experiment_dir>" \
        --num-samples 10

Runs on the card (cuda:<device-id>) unless `--device cpu` is given.
`--on-device-fid` keeps the samples and their features on the device.
With the --dist-* flags (train_image's; parallel/multihost.py) the samples
shard over the ranks, every rank gets the same score and the primary
writes the artifacts and prints it; `--mesh-data N` must then equal the
number of ranks.
"""

import argparse
import glob
import logging
import os

from .evaluation import eval_image_experiment, hydrate_config
from .parallel import mesh, multihost
from .utils.logger import register_stack_dump


def run(argv, evaluate, metric: str) -> None:
    """The eval CLIs' shared body: parse the flags, then for each
    experiment dir of the --exp-dir glob print `<metric>: <value>` from
    evaluate(cfg, exp_dir, device=...)."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--device-id', default=0, type=int, help='Device ID')
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                        help='run on the card (default) or the CPU')
    parser.add_argument('--exp-dir', type=str, required=True,
                        help='Experiment directory (glob)')
    parser.add_argument('--netG', type=str, default='',
                        help='checkpoint file name (default: netG_<scale>.ckpt)')
    parser.add_argument('--save-path', type=str, default='images',
                        help='New directory for outputs')
    parser.add_argument('--num-samples', type=int, default=10,
                        help='number of samples to generate')
    parser.add_argument('--niter', type=int, default=1, help='number of epochs')
    parser.add_argument('--batch-size', type=int, default=1)
    parser.add_argument('--data-rep', type=int, default=1)
    parser.add_argument('--scale-idx', type=int, default=-1,
                        help='scale to evaluate (-1: last trained)')
    parser.add_argument('--max-samples', type=int, default=4)
    parser.add_argument('--mesh-data', type=int, default=1,
                        help='data-parallel ranks (the sample batch shards '
                             'over them; a multi-process run shards over '
                             'every rank without it)')
    parser.add_argument('--on-device-fid', action='store_true', default=False,
                        help='device-resident sampling + sinFID: only '
                             'per-sample (mu, sigma) stats leave the device '
                             '(BASELINE config 5)')
    multihost.add_dist_flags(parser)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(levelname)s %(message)s')
    register_stack_dump()
    device = mesh.select_device(args.device, args.device_id,
                                args.dist_procid)
    multihost.init_from_cfg(args, device)
    mesh.eval_group(args.mesh_data)  # refuse a data axis it cannot run
    for exp_dir in sorted(glob.glob(args.exp_dir)):
        if not os.path.exists(os.path.join(exp_dir, 'args.txt')):
            logging.info('Skipping %s (no args.txt)', exp_dir)
            continue
        overrides = dict(niter=args.niter, data_rep=args.data_rep,
                         batch_size=args.batch_size,
                         num_samples=args.num_samples,
                         max_samples=args.max_samples,
                         save_path=args.save_path, scale_idx=args.scale_idx,
                         mesh_data=args.mesh_data,
                         on_device_fid=args.on_device_fid,
                         netG=(os.path.join(exp_dir, args.netG)
                               if args.netG else ''))
        cfg = hydrate_config(exp_dir, overrides)
        value, _ = evaluate(cfg, exp_dir, device=device)
        if multihost.is_primary():
            print(f'{metric}: {value}')


def main(argv=None):
    run(argv, eval_image_experiment, 'SIFID')


if __name__ == '__main__':
    main()
