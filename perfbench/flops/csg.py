"""The convolution FLOPs of the CSG video baseline's training iteration,
from the configuration's shapes, at 2 FLOPs a multiply-add
(reference/csg.py has the layers).

The generator's convolutions keep no size: the head and the tail take the
1 they are padded by, and each of a stage's num_layer + 1 convolutions
takes 2 off every axis of the stage's input, which is padded by num_layer
+ 1, so that the stage's output has the scale's shape. A convolution of
cin -> cout channels and a k^3 kernel whose output has `out` voxels costs
F = 2 B cout cin k^3 out in its forward, and as much in its input
gradient (dgrad) and its weight gradient (wgrad) (flops/hpvaegan.py's
`conv_flops` at the output's shape). The critic's convolutions keep the
size of its input padded by num_layer + 2.

`iteration` counts the work the iteration needs, and nothing recomputed:
  D step  G's random forward (head, every stage, tail); the critic on the
          real, the fake and the GP's interpolate; the GP's input
          gradient, its double backward and the real and fake passes'
          backward, as flops/hpvaegan.py counts them for its critic, whose
          layers these are.
  G step  the reconstruction and the random forward (each the whole
          generator); the critic on the fake and its dgrads; and, through
          both, the wgrads and dgrads of the trainable stages and the
          tail (the lowest trainable stage's first convolution needs no
          dgrad: its input comes from the frozen stages).
`autograd_extra` is what PyTorch's autograd also runs, all of it in the
critic's double backward (tests/test_torch_csg_reference.py holds their
sum to torch.utils.flop_counter's count of one iteration).

A cost is a function of one convolution (cin, cout, cfg, input shape,
output shape, batch): by default its FLOPs; `roofline` gives its least
seconds on a card, the larger of its FLOPs over the peak and its bytes
over the memory bandwidth, where a forward, a dgrad and a wgrad each move
the input and output activations and the weights once (`conv_bytes`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

from ..reference.csg import trainable
from ..reference.hpvaegan import scale_shape
from . import hpvaegan

Shape = Tuple[int, ...]
Conv = Tuple[int, int, Shape, Shape]  # cin, cout, input and output shape
Cost = Callable[[int, int, dict, Shape, Shape, int], float]


def conv_flops(cin: int, cout: int, cfg: dict, shape_in: Shape,
               shape_out: Shape, batch: int) -> int:
    return hpvaegan.conv_flops(cin, cout, cfg, shape_out, batch)


def conv_bytes(cin: int, cout: int, cfg: dict, shape_in: Shape,
               shape_out: Shape, batch: int) -> int:
    """flops/hpvaegan.py's bytes of a convolution whose input has another
    shape than its output."""
    return hpvaegan.conv_bytes(cin, cout, cfg, shape_out, batch) + 4 * batch \
        * cin * (math.prod(shape_in) - math.prod(shape_out))


def roofline(peak_flops: float, bytes_per_s: float) -> Cost:
    """The cost of a float32 convolution in seconds at its roofline."""
    def cost(*conv):
        return max(conv_flops(*conv) / peak_flops,
                   conv_bytes(*conv) / bytes_per_s)
    return cost


def _grown(shape: Shape, by: int) -> Shape:
    return tuple(s + 2 * by for s in shape)


def _head(cfg: dict) -> List[Conv]:
    shape = scale_shape(cfg, 0)
    return [(cfg["nc_im"], cfg["nfc"], _grown(shape, 1), shape)]


def _stage(cfg: dict, k: int) -> List[Conv]:
    shape, p, nfc = scale_shape(cfg, k), cfg["num_layer"] + 1, cfg["nfc"]
    return [(nfc, nfc, _grown(shape, p - j), _grown(shape, p - j - 1))
            for j in range(p)]


def _tail(cfg: dict, k: int) -> List[Conv]:
    shape = scale_shape(cfg, k)
    return [(cfg["nfc"], cfg["nc_im"], _grown(shape, 1), shape)]


def _critic(cfg: dict) -> List[Conv]:
    """The critic's convolutions, each of the same in and out shape
    (padd_size = ker // 2, as published)."""
    shape = _grown(scale_shape(cfg, cfg["scale_idx"]), cfg["num_layer"] + 2)
    nfc = cfg["nfc"]
    return [(cin, cout, shape, shape) for cin, cout in
            [(cfg["nc_im"], nfc)] + [(nfc, nfc)] * cfg["num_layer"]
            + [(nfc, 1)]]


def _each(convs: List[Conv], cfg: dict, batch: int, cost: Cost
          ) -> List[float]:
    return [cost(a, b, cfg, i, o, batch) for a, b, i, o in convs]


def iteration(cfg: dict, batch: int,
              cost: Cost = conv_flops) -> Dict[str, float]:
    """The D step's and the G step's cost at scale cfg["scale_idx"] on a
    batch of `batch`, and their sum under "total"."""
    s = cfg["scale_idx"]
    if "head." in trainable(cfg, s + 1):
        raise ValueError("the count holds scales whose head is frozen "
                         "(scale_idx >= train_depth)")
    stages = [_each(_stage(cfg, k), cfg, batch, cost) for k in range(s + 1)]
    tail = sum(_each(_tail(cfg, s), cfg, batch, cost))
    gen = sum(_each(_head(cfg), cfg, batch, cost)) \
        + sum(map(sum, stages)) + tail
    d = _each(_critic(cfg), cfg, batch, cost)
    d_step = (gen + 3 * sum(d)                  # G's fake; D on 3 inputs
              + sum(d)                          # the GP's input gradient
              + sum(d) - d[-1] + sum(d)         # its double backward
              + 2 * (sum(d) + sum(d) - d[0]))   # real and fake backward
    train = sorted(int(k.split(".")[1]) for k in trainable(cfg, s + 1)
                   if k.startswith("body."))
    g_back = 2 * tail  # the tail's wgrad and dgrad
    for j in train:
        # wgrads, and dgrads down to the lowest trainable stage's first conv
        g_back += 2 * sum(stages[j]) - (stages[j][0] if j == train[0] else 0)
    g_step = (gen + gen             # the reconstruction, then the fake
              + sum(d) + sum(d)     # D on the fake, and its dgrads
              + 2 * g_back)         # through the reconstruction and fake
    return {"d_step": d_step, "g_step": g_step, "total": d_step + g_step}


def autograd_extra(cfg: dict, batch: int) -> int:
    """The double backward's convolutions that the iteration does not
    need and autograd runs (see the module's docstring)."""
    d = _each(_critic(cfg), cfg, batch, conv_flops)
    return 3 * sum(d) - 2 * d[-1]
