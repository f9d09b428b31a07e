"""C3D (Sports-1M architecture) feature blocks, the SVFID feature extractor.

The port of the JAX package's `metrics/c3d.py` (reference
src/sinFID/c3d.py:6-142, whose shipped version does not run): blocks
conv1a(64) + pool1 | conv2a(128) + pool2 | conv3a/b(256) + pool3 |
conv4a/b(512) + pool4, each conv 3x3x3 with padding 1 then ReLU, each pool
a VALID max-pool with kernel = stride (pool1 keeps time). Weights come from
the same .npz the JAX package reads (keys "<conv>.w" in DHWIO, "<conv>.b"),
named by `weights=` or HPVAEGAN_C3D_WEIGHTS; with them the input is scaled
to [0, 255], as the pretrained weights expect, else to [-1, 1].

Without a weights file both packages use a seeded random init, but from
different generators (jax.random there, torch.Generator here), so their
random-feature SVFIDs differ. Only with one shared .npz are the two
packages' SVFIDs comparable.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

BLOCK_INDEX_BY_DIM = {64: 0, 128: 1, 256: 2, 512: 3}

# (name, cin, cout) 3x3x3 convs per block; a pool after each block
_BLOCKS = [
    [("conv1a", 3, 64)],
    [("conv2a", 64, 128)],
    [("conv3a", 128, 256), ("conv3b", 256, 256)],
    [("conv4a", 256, 512), ("conv4b", 512, 512)],
]
# pool window = stride per block, (T, H, W)
_POOLS = [(1, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2)]


def _init_params(seed: int) -> Dict[str, np.ndarray]:
    gen = torch.Generator().manual_seed(int(seed))
    params: Dict[str, np.ndarray] = {}
    for block in _BLOCKS:
        for name, cin, cout in block:
            w = torch.randn((3, 3, 3, cin, cout), generator=gen)
            params[f"{name}.w"] = (w / np.sqrt(cin * 27)).numpy()
            params[f"{name}.b"] = np.zeros((cout,), np.float32)
    return params


class C3D:
    """Feature extractor: __call__(x) -> list of the requested block
    features, NCDHW. x: (B, 3, T, H, W) float in [0, 1]. Runs on the card
    unless `device` asks for the CPU; raises if no card is present."""

    BLOCK_INDEX_BY_DIM = BLOCK_INDEX_BY_DIM

    def __init__(self, output_blocks: List[int] = (0,),
                 weights: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        self.output_blocks = sorted(output_blocks)
        weights = weights or os.environ.get("HPVAEGAN_C3D_WEIGHTS", "")
        if weights and not os.path.exists(weights):
            # an explicit request must not degrade to random features
            raise FileNotFoundError(f"C3D weights file not found: {weights}")
        if weights:
            with np.load(weights) as npz:
                self.params = {k: np.asarray(npz[k]) for k in npz.files}
        else:
            self.params = _init_params(seed)
        self.pretrained = bool(weights)
        self.device = resolve_device(device)
        self._blocks = []
        for block in _BLOCKS[:max(self.output_blocks) + 1]:
            convs = []
            for name, _, _ in block:
                w = torch.from_numpy(np.ascontiguousarray(
                    self.params[f"{name}.w"], np.float32))
                b = torch.from_numpy(np.ascontiguousarray(
                    self.params[f"{name}.b"], np.float32))
                convs.append((w.permute(4, 3, 0, 1, 2).contiguous()  # OIDHW
                              .to(self.device), b.to(self.device)))
            self._blocks.append(convs)

    def __call__(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.to(self.device, torch.float32)
        # the pretrained Sports-1M weights take RGB in [0, 255]
        x = x * 255.0 if self.pretrained else x * 2.0 - 1.0
        outs = []
        with torch.no_grad():
            for bi, convs in enumerate(self._blocks):
                for w, b in convs:
                    x = F.relu(F.conv3d(x, w, b, padding=1))
                x = F.max_pool3d(x, _POOLS[bi], stride=_POOLS[bi])
                if bi in self.output_blocks:
                    outs.append(x)
        return outs
