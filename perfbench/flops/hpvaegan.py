"""The convolution FLOPs of HP-VAE-GAN's training iteration and sampler,
from the configuration's shapes, at 2 FLOPs a multiply-add.

Every convolution keeps its input's spatial size (padding ker // 2), so a
convolution of cin -> cout channels with a k^ndim kernel on B samples of
the scale's shape costs F = 2 B cout cin k^ndim prod(shape) in its
forward, and as much in each of its input gradient (dgrad) and weight
gradient (wgrad).

`iteration` counts the work the GAN-scale iteration needs, and nothing
recomputed:
  D step  G's random forward (decoder and every stage); the critic on the
          real, the fake and the GP's interpolate; the GP's input
          gradient (a dgrad of every critic conv); its double backward (a
          forward conv of every critic conv but the tail, whose incoming
          gradient is constant, and a wgrad of every critic conv); the
          wgrads and dgrads (but the head's: its inputs need none) of the
          real and the fake passes.
  G step  the reconstruction (encoder, decoder, every stage); G's random
          forward; the critic on the fake and its dgrads; and, through
          the reconstruction and through the fake, the wgrads and dgrads
          of the trainable stages (the lowest one's head needs no dgrad).
`autograd_extra` is what PyTorch's autograd also runs in the GP's double
backward: the tail's forward conv on a constant gradient, and, since
LeakyReLU's backward hands its input a gradient of zeros, a wgrad of every
critic conv but the tail and a dgrad of those but the head, all on zeros.
Their sum is what torch.utils.flop_counter counts of one iteration
(perfbench/tests/test_flops.py). Spectral norm's power iteration
(matrix-vector products of at most 64 x 1728) is left out: under 1e-5 of
the iteration's FLOPs.

Every count is a sum over the convolutions of a cost of one convolution,
by default its FLOPs. `roofline` gives the other cost the metrics use: a
convolution's least seconds on a card, the larger of its FLOPs over the
peak and its bytes over the memory bandwidth, where a forward, a dgrad
and a wgrad each move the input and output activations and the weights
once (`conv_bytes`). A 3 -> 64 head moves ~13 FLOPs a byte and a
64 -> 64 one ~144, near the H100's TF32 ridge (~148), so neither count
alone bounds their time.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

from ..reference.hpvaegan import scale_shape, trainable

Convs = List[Tuple[int, int]]  # (cin, cout) of each conv, in order
Cost = Callable[[int, int, dict, tuple, int], float]


def conv_flops(cin: int, cout: int, cfg: dict, shape, batch: int) -> int:
    return 2 * batch * cout * cin * cfg["ker_size"] ** cfg["ndim"] \
        * math.prod(shape)


def conv_bytes(cin: int, cout: int, cfg: dict, shape, batch: int) -> int:
    return 4 * (batch * (cin + cout) * math.prod(shape)
                + cout * cin * cfg["ker_size"] ** cfg["ndim"])


def roofline(peak_flops: float, bytes_per_s: float) -> Cost:
    """The cost of a float32 convolution in seconds at its roofline."""
    def cost(cin, cout, cfg, shape, batch):
        return max(conv_flops(cin, cout, cfg, shape, batch) / peak_flops,
                   conv_bytes(cin, cout, cfg, shape, batch) / bytes_per_s)
    return cost


def _stack(cin: int, cout: int, cfg: dict) -> Convs:
    nfc = cfg["nfc"]
    return [(cin, nfc)] + [(nfc, nfc)] * cfg["num_layer"] + [(nfc, cout)]


def _encoder(cfg: dict) -> Convs:
    nfc = cfg["nfc"]
    chans = [cfg["nc_im"]] + [nfc] * (cfg["enc_blocks"] + 1)
    return [(chans[i], chans[i + 1]) for i in range(cfg["enc_blocks"] + 1)] \
        + [(nfc, cfg["latent_dim"])] * 2


def _critic(cfg: dict) -> Convs:
    return _stack(cfg["nc_im"], 1, cfg)


def _each(convs: Convs, cfg: dict, shape, batch: int,
          cost: Cost = conv_flops) -> List[float]:
    return [cost(a, b, cfg, shape, batch) for a, b in convs]


def _generator(cfg: dict, stages: int, batch: int, z_shape=None,
               cost: Cost = conv_flops) -> float:
    """G's random forward: the decoder (on z of `z_shape`, by default
    scale 0's), then stages 1 .. `stages`."""
    total = sum(_each(_stack(cfg["latent_dim"], cfg["nc_im"], cfg), cfg,
                      z_shape or scale_shape(cfg, 0), batch, cost))
    for k in range(1, stages + 1):
        total += sum(_each(_stack(cfg["nc_im"], cfg["nc_im"], cfg), cfg,
                           scale_shape(cfg, k), batch, cost))
    return total


def sample(cfg: dict, stages: int, n: int, cost: Cost = conv_flops) -> float:
    """One call of the sampler: G's random forward on n samples (in video,
    z has the time depth of the scale sampled, as the eval draws it)."""
    z = scale_shape(cfg, 0)
    if cfg["ndim"] == 3:
        z = (scale_shape(cfg, stages)[0],) + tuple(z[1:])
    return _generator(cfg, stages, n, z, cost)


def iteration(cfg: dict, batch: int,
              cost: Cost = conv_flops) -> Dict[str, float]:
    """The D step's and the G step's cost at GAN scale cfg["scale_idx"]
    on a global batch of `batch`, and their sum under "total"."""
    s = cfg["scale_idx"]
    d = _each(_critic(cfg), cfg, scale_shape(cfg, s), batch, cost)
    gen = _generator(cfg, s, batch, cost=cost)
    d_step = (gen + 3 * sum(d)                  # G's fake; D on 3 inputs
              + sum(d)                          # the GP's input gradient
              + sum(d) - d[-1] + sum(d)         # its double backward
              + 2 * (sum(d) + sum(d) - d[0]))   # real and fake backward
    enc = sum(_each(_encoder(cfg), cfg, scale_shape(cfg, 0), batch, cost))
    train = sorted(int(k.split(".")[1]) for k in trainable(cfg, s))
    g_back = 0
    for j in train:
        st = _each(_stack(cfg["nc_im"], cfg["nc_im"], cfg), cfg,
                   scale_shape(cfg, j + 1), batch, cost)
        # wgrads, and dgrads down to the lowest trainable stage's head
        g_back += sum(st) + sum(st) - (st[0] if j == train[0] else 0)
    g_step = (enc + gen + gen       # the reconstruction, then the fake
              + sum(d) + sum(d)     # D on the fake, and its dgrads
              + 2 * g_back)         # through the reconstruction and fake
    return {"d_step": d_step, "g_step": g_step, "total": d_step + g_step}


def autograd_extra(cfg: dict, batch: int) -> int:
    """The double backward's convolutions that the iteration does not
    need and autograd runs (see the module's docstring)."""
    d = _each(_critic(cfg), cfg, scale_shape(cfg, cfg["scale_idx"]), batch)
    return d[-1] + (sum(d) - d[-1]) + (sum(d) - d[-1] - d[0])
