"""InceptionV3 FID feature blocks 0-3 (64 / 192 / 768 / 2048-d), the
SIFID feature extractor.

The port of the JAX package's `metrics/inception.py` (reference
src/sinFID/inception.py:6-144; SIFID uses dims 64, fid_score.py:208-211):
  block 0: Conv2d_1a/2a/2b, then a VALID 3x3 stride-2 max pool
  block 1: Conv2d_3b/4a, then the same max pool
  block 2: Mixed_5b .. Mixed_6e (InceptionA x 3, B, C x 4)
  block 3: Mixed_7a .. Mixed_7c (InceptionD, E x 2), then a spatial mean
           to 1x1
Every conv runs with inference-mode BatchNorm (eps 1e-3) and ReLU. The
branch average pools divide by the window's count of unpadded positions
(`count_include_pad=False`, pytorch-fid's FIDInceptionA/C/E), and
Mixed_7c's branch pool is a max pool (FIDInceptionE_2). Weights come from
the same .npz the JAX package reads (keys "<module>.w" in HWIO,
"<module>.bn_gamma/bn_beta/bn_mean/bn_var"; tools/metric_weights.py writes
it), named by `weights=` or HPVAEGAN_INCEPTION_WEIGHTS.

Without a weights file both packages use the same seeded random init: conv
i (in the order of `_iter_convs`) draws jax.random.normal(fold_in(
PRNGKey(seed), i)) / sqrt(fan_in), which utils/jax_prng.py reproduces bit
for bit, so the two packages' default features agree at every block and
seed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.jax_prng import folded_normal

BLOCK_INDEX_BY_DIM = {64: 0, 192: 1, 768: 2, 2048: 3}
_BN = ("bn_gamma", "bn_beta", "bn_mean", "bn_var")

# conv spec: (name, cout, (kh, kw), (sh, sw), (ph, pw)); a pool is
# ("avgpool" | "maxpool", None, kernel, stride, padding); a "split" holds
# parallel convs whose outputs concatenate
Conv = Tuple[str, int, Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def _c(name, cout, k, s=(1, 1), p=(0, 0)) -> Conv:
    return (name, cout, k, s, p)


def _inception_a(prefix: str, pool_features: int):
    return {"branches": [
        [_c(f"{prefix}.branch1x1", 64, (1, 1))],
        [_c(f"{prefix}.branch5x5_1", 48, (1, 1)),
         _c(f"{prefix}.branch5x5_2", 64, (5, 5), p=(2, 2))],
        [_c(f"{prefix}.branch3x3dbl_1", 64, (1, 1)),
         _c(f"{prefix}.branch3x3dbl_2", 96, (3, 3), p=(1, 1)),
         _c(f"{prefix}.branch3x3dbl_3", 96, (3, 3), p=(1, 1))],
        [("avgpool", None, (3, 3), (1, 1), (1, 1)),
         _c(f"{prefix}.branch_pool", pool_features, (1, 1))],
    ]}


def _inception_b(prefix: str):
    return {"branches": [
        [_c(f"{prefix}.branch3x3", 384, (3, 3), s=(2, 2))],
        [_c(f"{prefix}.branch3x3dbl_1", 64, (1, 1)),
         _c(f"{prefix}.branch3x3dbl_2", 96, (3, 3), p=(1, 1)),
         _c(f"{prefix}.branch3x3dbl_3", 96, (3, 3), s=(2, 2))],
        [("maxpool", None, (3, 3), (2, 2), (0, 0))],
    ]}


def _inception_c(prefix: str, c7: int):
    return {"branches": [
        [_c(f"{prefix}.branch1x1", 192, (1, 1))],
        [_c(f"{prefix}.branch7x7_1", c7, (1, 1)),
         _c(f"{prefix}.branch7x7_2", c7, (1, 7), p=(0, 3)),
         _c(f"{prefix}.branch7x7_3", 192, (7, 1), p=(3, 0))],
        [_c(f"{prefix}.branch7x7dbl_1", c7, (1, 1)),
         _c(f"{prefix}.branch7x7dbl_2", c7, (7, 1), p=(3, 0)),
         _c(f"{prefix}.branch7x7dbl_3", c7, (1, 7), p=(0, 3)),
         _c(f"{prefix}.branch7x7dbl_4", c7, (7, 1), p=(3, 0)),
         _c(f"{prefix}.branch7x7dbl_5", 192, (1, 7), p=(0, 3))],
        [("avgpool", None, (3, 3), (1, 1), (1, 1)),
         _c(f"{prefix}.branch_pool", 192, (1, 1))],
    ]}


def _inception_d(prefix: str):
    return {"branches": [
        [_c(f"{prefix}.branch3x3_1", 192, (1, 1)),
         _c(f"{prefix}.branch3x3_2", 320, (3, 3), s=(2, 2))],
        [_c(f"{prefix}.branch7x7x3_1", 192, (1, 1)),
         _c(f"{prefix}.branch7x7x3_2", 192, (1, 7), p=(0, 3)),
         _c(f"{prefix}.branch7x7x3_3", 192, (7, 1), p=(3, 0)),
         _c(f"{prefix}.branch7x7x3_4", 192, (3, 3), s=(2, 2))],
        [("maxpool", None, (3, 3), (2, 2), (0, 0))],
    ]}


def _inception_e(prefix: str):
    # pytorch-fid's FIDInceptionE_2 (Mixed_7c) pools its branch with a max
    pool_kind = "maxpool" if prefix == "Mixed_7c" else "avgpool"
    return {"branches": [
        [_c(f"{prefix}.branch1x1", 320, (1, 1))],
        [_c(f"{prefix}.branch3x3_1", 384, (1, 1)),
         ("split", [_c(f"{prefix}.branch3x3_2a", 384, (1, 3), p=(0, 1)),
                    _c(f"{prefix}.branch3x3_2b", 384, (3, 1), p=(1, 0))])],
        [_c(f"{prefix}.branch3x3dbl_1", 448, (1, 1)),
         _c(f"{prefix}.branch3x3dbl_2", 384, (3, 3), p=(1, 1)),
         ("split", [_c(f"{prefix}.branch3x3dbl_3a", 384, (1, 3), p=(0, 1)),
                    _c(f"{prefix}.branch3x3dbl_3b", 384, (3, 1), p=(1, 0))])],
        [(pool_kind, None, (3, 3), (1, 1), (1, 1)),
         _c(f"{prefix}.branch_pool", 192, (1, 1))],
    ]}


_STEM0 = [_c("Conv2d_1a_3x3", 32, (3, 3), s=(2, 2)),
          _c("Conv2d_2a_3x3", 32, (3, 3)),
          _c("Conv2d_2b_3x3", 64, (3, 3), p=(1, 1))]
_STEM1 = [_c("Conv2d_3b_1x1", 80, (1, 1)),
          _c("Conv2d_4a_3x3", 192, (3, 3))]
_MIXED2 = [_inception_a("Mixed_5b", 32), _inception_a("Mixed_5c", 64),
           _inception_a("Mixed_5d", 64), _inception_b("Mixed_6a"),
           _inception_c("Mixed_6b", 128), _inception_c("Mixed_6c", 160),
           _inception_c("Mixed_6d", 160), _inception_c("Mixed_6e", 192)]
_MIXED3 = [_inception_d("Mixed_7a"), _inception_e("Mixed_7b"),
           _inception_e("Mixed_7c")]
_BLOCKS = [_STEM0, _STEM1, _MIXED2, _MIXED3]


def _iter_convs(specs, cin: int):
    """Yield (name, cin, cout, kernel) for every conv of `specs` in order,
    following the channel counts through branches and splits."""
    for spec in specs:
        if not isinstance(spec, dict):
            name, cout, k, _, _ = spec
            yield name, cin, cout, k
            cin = cout
            continue
        outs = []
        for branch in spec["branches"]:
            b_cin = cin
            for item in branch:
                if item[0] == "split":
                    for sub in item[1]:
                        yield sub[0], b_cin, sub[1], sub[2]
                    b_cin = sum(sub[1] for sub in item[1])
                elif item[0] not in ("avgpool", "maxpool"):
                    yield item[0], b_cin, item[1], item[2]
                    b_cin = item[1]
            outs.append(b_cin)
        cin = sum(outs)


def _init_params(last_block: int, seed: int) -> Dict[str, np.ndarray]:
    """The JAX package's random init of blocks 0..last_block
    (metrics/inception.py:175-188 there), float32."""
    specs = [s for block in _BLOCKS[:last_block + 1] for s in block]
    params: Dict[str, np.ndarray] = {}
    for i, (name, cin, cout, k) in enumerate(_iter_convs(specs, 3)):
        w = folded_normal(seed, i, (k[0], k[1], cin, cout))
        # the JAX package divides in float64 (numpy 2 promotion) and casts
        # to float32 when the array reaches the device
        params[f"{name}.w"] = (w.astype(np.float64)
                               / np.sqrt(cin * k[0] * k[1])).astype(np.float32)
        params[f"{name}.bn_gamma"] = np.ones((cout,), np.float32)
        params[f"{name}.bn_beta"] = np.zeros((cout,), np.float32)
        params[f"{name}.bn_mean"] = np.zeros((cout,), np.float32)
        params[f"{name}.bn_var"] = np.ones((cout,), np.float32)
    return params


class InceptionV3:
    """Feature extractor: __call__(x) -> list of the requested block
    features, NCHW, in the order of `output_blocks` sorted. x: (B, 3, H, W)
    float in [0, 1]. Runs on the card unless `device` asks for the CPU;
    raises if no card is present."""

    BLOCK_INDEX_BY_DIM = BLOCK_INDEX_BY_DIM

    def __init__(self, output_blocks: List[int] = (0,),
                 weights: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        self.output_blocks = sorted(output_blocks)
        if not set(self.output_blocks) <= {0, 1, 2, 3}:
            raise ValueError(f"InceptionV3 blocks are 0-3, not "
                             f"{self.output_blocks}")
        self.last_needed_block = max(self.output_blocks)
        weights = weights or os.environ.get("HPVAEGAN_INCEPTION_WEIGHTS", "")
        if weights and not os.path.exists(weights):
            # an explicit request must not degrade to random features
            raise FileNotFoundError(
                f"Inception weights file not found: {weights}")
        if weights:
            with np.load(weights) as npz:
                self.params = {k: np.asarray(npz[k]) for k in npz.files}
        else:
            self.params = _init_params(self.last_needed_block, seed)
        self.pretrained = bool(weights)
        self.device = resolve_device(device)
        specs = [s for block in _BLOCKS[:self.last_needed_block + 1]
                 for s in block]
        self._convs: Dict[str, Tuple[torch.Tensor, ...]] = {}
        for name, _, _, _ in _iter_convs(specs, 3):
            w, gamma, beta, mean, var = (torch.from_numpy(np.ascontiguousarray(
                self.params[f"{name}.{k}"], np.float32)).to(self.device)
                for k in ("w",) + _BN)
            inv = torch.rsqrt(var + 1e-3) * gamma
            self._convs[name] = (w.permute(3, 2, 0, 1).contiguous(),  # OIHW
                                 *(t.reshape(1, -1, 1, 1)
                                   for t in (mean, inv, beta)))

    def _conv_bn(self, x, name, stride, pad):
        w, mean, inv, beta = self._convs[name]
        return F.relu((F.conv2d(x, w, stride=stride, padding=pad) - mean)
                      * inv + beta)

    def _branch(self, x, branch):
        for item in branch:
            if item[0] == "split":
                x = torch.cat([self._conv_bn(x, s[0], s[3], s[4])
                               for s in item[1]], dim=1)
            elif item[0] == "maxpool":
                x = F.max_pool2d(x, item[2], item[3], item[4])
            elif item[0] == "avgpool":
                x = F.avg_pool2d(x, item[2], item[3], item[4],
                                 count_include_pad=False)
            else:
                x = self._conv_bn(x, item[0], item[3], item[4])
        return x

    def _specs(self, x, specs):
        for spec in specs:
            if isinstance(spec, dict):
                x = torch.cat([self._branch(x, b) for b in spec["branches"]],
                              dim=1)
            else:
                x = self._conv_bn(x, spec[0], spec[3], spec[4])
        return x

    def __call__(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.to(self.device, torch.float32) * 2.0 - 1.0  # [0,1] -> [-1,1]
        outs = []
        with torch.no_grad():
            for bi in range(self.last_needed_block + 1):
                x = self._specs(x, _BLOCKS[bi])
                if bi < 2:
                    x = F.max_pool2d(x, 3, stride=2)
                elif bi == 3:
                    x = x.mean(dim=(2, 3), keepdim=True)  # adaptive 1x1
                if bi in self.output_blocks:
                    outs.append(x)
        return outs
