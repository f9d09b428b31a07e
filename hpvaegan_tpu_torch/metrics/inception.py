"""InceptionV3 feature block 0 (64-d), the SIFID feature extractor.

The port of the JAX package's `metrics/inception.py` for dims 64, the SIFID
default (reference src/sinFID/fid_score.py:208-211): the three stem convs
with inference-mode BatchNorm (eps 1e-3) and ReLU, then a 3x3 stride-2 max
pool. Weights come from the same .npz the JAX package reads (keys
"<conv>.w" in HWIO, "<conv>.bn_gamma/bn_beta/bn_mean/bn_var"), named by
`weights=` or HPVAEGAN_INCEPTION_WEIGHTS.

Without a weights file both packages use a seeded random init. At seed 0,
the only seed the CLIs use, the port loads the JAX package's own seed-0
arrays (`jax.random`, metrics/inception.py:175-188 there) from
default_init.npz beside this module, so the two packages' default SIFIDs
agree. Other seeds draw from a torch.Generator and differ from the JAX
package's. Blocks 1-3 (dims 192/768/2048) are not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

BLOCK_INDEX_BY_DIM = {64: 0, 192: 1, 768: 2, 2048: 3}
# the JAX package's seed-0 init of the blocks the CLIs use (written by
# tests/test_torch_metric_init.py), keys "inception/<conv>.<array>" and
# "c3d/<conv>.<array>"
DEFAULT_INIT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "default_init.npz")

# block 0: (name, cin, cout, kernel, stride, padding)
_STEM0 = [("Conv2d_1a_3x3", 3, 32, 3, 2, 0),
          ("Conv2d_2a_3x3", 32, 32, 3, 1, 0),
          ("Conv2d_2b_3x3", 32, 64, 3, 1, 1)]


def default_init(prefix: str) -> Dict[str, np.ndarray]:
    """The arrays of DEFAULT_INIT under `prefix` ("inception" or "c3d"),
    keyed without it."""
    with np.load(DEFAULT_INIT) as npz:
        return {k.split("/", 1)[1]: np.asarray(npz[k]) for k in npz.files
                if k.startswith(prefix + "/")}


def _init_params(seed: int) -> Dict[str, np.ndarray]:
    """Seed 0: the JAX package's arrays; other seeds: a torch draw."""
    if seed == 0:
        return default_init("inception")
    gen = torch.Generator().manual_seed(int(seed))
    params: Dict[str, np.ndarray] = {}
    for name, cin, cout, k, _, _ in _STEM0:
        w = torch.randn((k, k, cin, cout), generator=gen) / np.sqrt(cin * k * k)
        params[f"{name}.w"] = w.numpy()
        params[f"{name}.bn_gamma"] = np.ones((cout,), np.float32)
        params[f"{name}.bn_beta"] = np.zeros((cout,), np.float32)
        params[f"{name}.bn_mean"] = np.zeros((cout,), np.float32)
        params[f"{name}.bn_var"] = np.ones((cout,), np.float32)
    return params


class InceptionV3:
    """Feature extractor: __call__(x) -> list of the requested block
    features, NCHW. x: (B, 3, H, W) float in [0, 1]. Runs on the card
    unless `device` asks for the CPU; raises if no card is present."""

    BLOCK_INDEX_BY_DIM = BLOCK_INDEX_BY_DIM

    def __init__(self, output_blocks: List[int] = (0,),
                 weights: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        self.output_blocks = sorted(output_blocks)
        if self.output_blocks != [0]:
            raise NotImplementedError(
                "only InceptionV3 block 0 (dims 64) is ported")
        weights = weights or os.environ.get("HPVAEGAN_INCEPTION_WEIGHTS", "")
        if weights and not os.path.exists(weights):
            # an explicit request must not degrade to random features
            raise FileNotFoundError(
                f"Inception weights file not found: {weights}")
        if weights:
            with np.load(weights) as npz:
                self.params = {k: np.asarray(npz[k]) for k in npz.files}
        else:
            self.params = _init_params(seed)
        self.device = resolve_device(device)
        self._convs = []
        for name, _, _, _, stride, pad in _STEM0:
            t = {k: torch.from_numpy(np.ascontiguousarray(
                self.params[f"{name}.{k}"], np.float32)).to(self.device)
                for k in ("w", "bn_gamma", "bn_beta", "bn_mean", "bn_var")}
            t["w"] = t["w"].permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
            self._convs.append((t, stride, pad))

    def __call__(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.to(self.device, torch.float32) * 2.0 - 1.0  # [0,1] -> [-1,1]
        with torch.no_grad():
            for t, stride, pad in self._convs:
                y = F.conv2d(x, t["w"], stride=stride, padding=pad)
                inv = torch.rsqrt(t["bn_var"] + 1e-3) * t["bn_gamma"]
                y = (y - t["bn_mean"].reshape(1, -1, 1, 1)) \
                    * inv.reshape(1, -1, 1, 1) + t["bn_beta"].reshape(1, -1, 1, 1)
                x = F.relu(y)
            x = F.max_pool2d(x, 3, stride=2)
        return [x]
