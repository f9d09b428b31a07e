"""Export CLI (the port of the repo's export.py): rebuild netG at the saved
scale, write the runner's input bins (preprocess.py) and export the
random-mode sampler.

    python -m hpvaegan_tpu_torch.export --exp-dir <experiment_dir> \
        [--num-samples N] [--batch-size B] [--netG FILE]

Writes into <exp-dir>/infer/: the bins, <netG>.pt2 (`torch.export.save`),
<netG>.aoti.pt2 (AOTInductor's compile of it, which the native runner
loads; on the card by default, `--no-native` skips it) and io_spec.txt
(the text the JAX export CLI writes). No compile_options.bin: that file
is PJRT's. The checkpoint may be the JAX package's or the port's pickle,
an original hp-vae-gan .pth or a MindSpore .ckpt. Runs on the card
unless `--device cpu` is given.
"""

import argparse
import os
import time

import torch

from ..evaluation import hydrate_config, load_generator
from ..models import BASELINES
from ..preprocess import pre_process
from ..utils.device import resolve_device
from .serving import (BASELINE_REFUSAL, compile_native, export_sampler,
                      io_spec_text, save_exported, serving_input_specs)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--exp-dir', type=str, required=True,
                        help='Experiment directory')
    parser.add_argument('--device-id', default=0, type=int, help='Device ID')
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                        help='export for the card (default) or the CPU')
    parser.add_argument('--format', type=str, default='PT2',
                        help='kept for reference-CLI parity; always '
                             'torch.export (.pt2)')
    parser.add_argument('--netG', type=str, default='',
                        help='checkpoint file (default: netG_<scale>.ckpt)')
    parser.add_argument('--scale-idx', type=int, default=-1,
                        help='scale to serve (-1: the last finalized)')
    parser.add_argument('--batch-size', type=int, default=1)
    parser.add_argument('--num-samples', type=int, default=1,
                        help='noise bins to write for the runner (one '
                             'inference per bin, latency averaged)')
    parser.add_argument('--native', action=argparse.BooleanOptionalAction,
                        default=None,
                        help='also compile <netG>.aoti.pt2 for the native '
                             'runner (default: on the card only; no '
                             'compile_options.bin is written, that is '
                             "PJRT's)")
    args = parser.parse_args(argv)
    device = resolve_device(f'cuda:{args.device_id}'
                            if args.device == 'cuda' else 'cpu')
    native = args.device == 'cuda' if args.native is None else args.native

    cfg = hydrate_config(args.exp_dir, dict(batch_size=args.batch_size,
                                            scale_idx=args.scale_idx))
    if cfg.generator in BASELINES:
        raise SystemExit(f'{cfg.generator}: {BASELINE_REFUSAL}')
    infer_dir = os.path.join(args.exp_dir, 'infer')
    # writes the bins and resolves cfg.scale_idx from intermediate.json
    pre_process(cfg, args.exp_dir, num_samples=args.num_samples)

    netG = args.netG or f'netG_{cfg.scale_idx}.ckpt'
    path = netG if os.path.isabs(netG) else os.path.join(args.exp_dir, netG)
    # video experiments (args.txt names a video) export the 3D sampler
    ndim = 3 if getattr(cfg, 'video_path', '') else 2
    generator, _ = load_generator(cfg, args.exp_dir, ndim=ndim, netG=path,
                                  device=device)
    prefix = os.path.join(infer_dir, os.path.basename(path).split('.')[0])

    def report(what, path, t0):
        line = f'{what} {path} in {time.perf_counter() - t0:.2f} s'
        if args.device == 'cuda':
            gb = torch.cuda.max_memory_allocated(device) / 1e9
            line += f', peak {gb:.3f} GB on {device}'
        print(line, flush=True)

    t0 = time.perf_counter()
    exported = export_sampler(cfg, generator, ndim=ndim,
                              batch=cfg.batch_size, device=device)
    save_exported(exported, prefix)
    report('exported', prefix + '.pt2', t0)
    if native:
        t0 = time.perf_counter()
        compile_native(exported, prefix + '.aoti.pt2')
        report('compiled', prefix + '.aoti.pt2', t0)
    with open(os.path.join(infer_dir, 'io_spec.txt'), 'w') as f:
        f.write(io_spec_text(serving_input_specs(cfg, ndim=ndim,
                                                 batch=cfg.batch_size)))


if __name__ == '__main__':
    main()
