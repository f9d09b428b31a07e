"""Convert pretrained metric-network weights into the .npz both packages
read (HPVAEGAN_INCEPTION_WEIGHTS / HPVAEGAN_C3D_WEIGHTS); the port of the
JAX package's `tools/metric_weights.py`.

    python -m hpvaegan_tpu_torch.tools.metric_weights inception pt_inception.pth out.npz
    python -m hpvaegan_tpu_torch.tools.metric_weights c3d c3d.pickle out.npz

`inception` takes a torchvision-style InceptionV3 state_dict (the
pytorch-fid FID-weights file: modules Conv2d_1a_3x3 .. Mixed_7c with
.conv.weight and .bn.{weight,bias,running_mean,running_var}); `c3d` the
C3D-pytorch Sports-1M state_dict (conv1 .. conv4b). Conv weights are
stored HWIO / DHWIO, as the JAX package keeps them. Without such a file
both packages score with the same seeded random features (relative
comparisons only).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _np(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


_BN = {".bn.weight": ".bn_gamma", ".bn.bias": ".bn_beta",
       ".bn.running_mean": ".bn_mean", ".bn.running_var": ".bn_var"}


def inception_state_dict_to_npz(sd: Dict, out_path: str) -> int:
    """torchvision InceptionV3 names -> metrics/inception.py's:
    <module>.conv.weight (OIHW) -> <module>.w (HWIO), .bn.* -> .bn_*.
    Returns the number of arrays written."""
    out: Dict[str, np.ndarray] = {}
    for key, value in sd.items():
        if key.endswith(".conv.weight"):
            out[key[:-len(".conv.weight")] + ".w"] = \
                _np(value).transpose(2, 3, 1, 0)
            continue
        for suffix, name in _BN.items():
            if key.endswith(suffix):
                out[key[:-len(suffix)] + name] = _np(value)
    np.savez(out_path, **out)
    return len(out)


def c3d_state_dict_to_npz(sd: Dict, out_path: str) -> int:
    """C3D-pytorch names (conv1 .. conv4b, OIDHW) -> metrics/c3d.py's
    (conv1a .. conv4b, DHWIO). Returns the number of arrays written."""
    rename = {"conv1": "conv1a", "conv2": "conv2a"}
    out: Dict[str, np.ndarray] = {}
    for key, value in sd.items():
        if not key.startswith("conv"):
            continue
        name, kind = key.split(".", 1)
        name = rename.get(name, name)
        if kind == "weight":
            out[f"{name}.w"] = _np(value).transpose(2, 3, 4, 1, 0)
        elif kind == "bias":
            out[f"{name}.b"] = _np(value)
    np.savez(out_path, **out)
    return len(out)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("kind", choices=["inception", "c3d"])
    p.add_argument("src", help="torch checkpoint (.pth/.pickle)")
    p.add_argument("out", help="output .npz")
    args = p.parse_args(argv)

    # weights_only: a state_dict of tensors needs no other class
    sd = torch.load(args.src, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    fn = inception_state_dict_to_npz if args.kind == "inception" \
        else c3d_state_dict_to_npz
    n = fn(sd, args.out)
    print(f"wrote {n} arrays to {args.out}")


if __name__ == "__main__":
    main()
