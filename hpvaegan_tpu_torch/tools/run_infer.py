"""The native serving chain (the port of scripts/run_infer_tpu.sh):
export -> build the runner -> run it -> postprocess.

    python -m hpvaegan_tpu_torch.tools.run_infer <experiment_dir> \
        [--num-samples N] [--run-only] [--device cuda|cpu]

Export writes the bins and <netG>.aoti.pt2 (`python -m
hpvaegan_tpu_torch.export --native`), native/build.py builds the runner,
the runner runs the newest <netG>.aoti.pt2 of <exp>/infer once per noise
bin from the experiment dir (so time_Result/ lands there) and prints its
average latency, and postprocess writes the PNGs or clips and prints
SIFID / SVFID. `--run-only` runs the runner alone on an experiment
exported before (re-measuring latency). On the card unless `--device cpu`.
"""

import argparse
import glob
import os
import subprocess
import sys


def run_runner(exp_dir: str, allow_tf32: bool = False) -> str:
    """Run the built runner on <exp>/infer's newest package and bins;
    returns its standard output (the latency line)."""
    from ..native.build import build

    infer = os.path.join(exp_dir, 'infer')
    # the newest package: an older --netG export would not match the bins
    models = sorted(glob.glob(os.path.join(infer, 'netG_*.aoti.pt2')),
                    key=os.path.getmtime)
    if not models:
        raise FileNotFoundError(f'no netG_*.aoti.pt2 in {infer}; export '
                                'with --native first')
    res = subprocess.run(
        [str(build()), f'--model_path={models[-1]}',
         f'--input0_path={infer}/noise_init',
         f'--input1_path={infer}/noise_amps',
         f'--input2_path={infer}/seed', f'--output_dir={infer}/result',
         f'--allow_tf32={int(allow_tf32)}'],
        cwd=exp_dir, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    sys.stderr.write(res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f'runner exit {res.returncode}: '
                           f'{res.stderr.strip()[-2000:]}')
    return res.stdout


def main(argv=None):
    from .. import postprocess
    from ..export.__main__ import main as export_main

    parser = argparse.ArgumentParser()
    parser.add_argument('exp_dir')
    parser.add_argument('--num-samples', type=int, default=1,
                        help='noise bins (one inference each, latency '
                             'averaged)')
    parser.add_argument('--run-only', action='store_true',
                        help='only run the runner on an earlier export')
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = parser.parse_args(argv)
    exp_dir = os.path.abspath(args.exp_dir)
    if not args.run_only:
        print('== export ==', flush=True)
        export_main(['--exp-dir', exp_dir, '--device', args.device,
                     '--num-samples', str(args.num_samples), '--native'])
    print('== run ==', flush=True)
    print(run_runner(exp_dir), end='', flush=True)
    if not args.run_only:
        print('== postprocess ==', flush=True)
        postprocess.main(['--exp-dir', exp_dir, '--device', args.device])


if __name__ == '__main__':
    main()
