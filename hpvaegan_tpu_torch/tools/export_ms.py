"""Write a trained generator as a MindSpore .ckpt (the port of the JAX
package's `tools/export_ms.py`).

An experiment's netG_<k>.ckpt, a pickled (params, state) pytree written by
either package, is renamed to the reference's MindSpore parameter names
(tools/convert.py::j2m_HPVAEGAN) and written in the Checkpoint protobuf
format (tools/ms_ckpt.py), which `mindspore.load_checkpoint` and the
reference's eval and resume read (reference train_image.py:374-377). 2D or
3D follows args.txt (a video_path means 3D).

    python -m hpvaegan_tpu_torch.tools.export_ms <exp_dir> [--scale K] \\
        [-o OUT]

writes <exp_dir>/netG_<k>.ms.ckpt by default, k from intermediate.json.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("exp_dir")
    ap.add_argument("--scale", type=int, default=-1,
                    help="scale index (default: intermediate.json's)")
    ap.add_argument("-o", "--out", default="",
                    help="output path (default: <exp>/netG_<k>.ms.ckpt)")
    args = ap.parse_args(argv)

    from ..config import Config
    from ..utils.saver import load_pytree
    from .convert import j2m_HPVAEGAN
    from .ms_ckpt import save_ms_checkpoint

    cfg = Config.from_args_txt(os.path.join(args.exp_dir, "args.txt"))
    with open(os.path.join(args.exp_dir, "intermediate.json")) as f:
        inter = json.load(f)
    k = args.scale if args.scale >= 0 else int(inter["scale_idx"])
    ndim = 3 if getattr(cfg, "video_path", "") else 2

    ckpt = load_pytree(os.path.join(args.exp_dir, f"netG_{k}.ckpt"))
    ms = j2m_HPVAEGAN(ckpt["params"], ckpt["state"], ndim=ndim)
    out = args.out or os.path.join(args.exp_dir, f"netG_{k}.ms.ckpt")
    save_ms_checkpoint(ms, out)
    print(f"wrote {out} ({len(ms)} parameters, scale {k}, {ndim}D)")
    return out


if __name__ == "__main__":
    main()
