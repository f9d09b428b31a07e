"""Explicit-generator noise: every random draw of a forward has one source.

`generate_noise` is the counterpart of the JAX package's
`utils/noise.py::generate_noise`, with a `torch.Generator` in place of the
PRNG key. `NoiseSource` bundles the draws of sampling and training — the
latent z_init, the per-stage refinement noise, the per-stage seed of the
fused upscale+noise kernel, the reparametrisation eps, the GP alpha, the
hflip flags, the video windows' starts and GeneratorVAE_nb's gate — so that
a test can replace it with one that hands out another framework's draws, in
call order. `get_state` / `set_state` carry both of its generators through
a checkpoint (utils/saver.py), so that a resumed run draws what the
uninterrupted one would have. `KeyedNoise` draws from the JAX seed stream
instead (utils/jax_prng.py), for the exported sampler. Under a data
group of several ranks a NoiseSource draws the rank's rows of the global
batch's draws, and under a spatial axis (`draw_rows`) the rank's rows of
H of the draw at the global height (of a padded layout's, too).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..parallel import mesh, spatial
from . import jax_prng
from .device import resolve_device


def generate_noise(gen: torch.Generator, shape: Sequence[int],
                   kind: str = "normal", dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """normal / bernoulli / uniform noise (reference: images.py:17-37)."""
    device = gen.device if device is None else device
    shape = tuple(int(s) for s in shape)
    if kind == "normal":
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)
    if kind in ("bernoulli", "benoulli"):  # reference spells it 'benoulli'
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        return (u < 0.5).to(dtype)
    if kind == "uniform":
        return torch.rand(shape, generator=gen, dtype=dtype, device=device)
    raise ValueError(f"unknown noise kind: {kind}")


class NoiseSource:
    """The draws of one sampling or training run, from a generator on
    `device`.

    Tensor draws come from a generator on the tensors' device. Kernel seeds
    are host integers and come from a second generator on the host, so that
    drawing one never waits for the device. A CUDA graph that draws from
    `gen` registers it with itself (training/chunk.py): every replay then
    advances it as the eager draws would, and get_state / set_state and
    eager draws between replays see and continue that one stream; a host
    draw inside the graph would not be drawn again, and is refused there.

    Under a data group of several ranks (parallel/mesh.py, the group in
    force) every rank holds the same generator states, and each batched
    draw, asked for with the rank's shape of b rows, is drawn at the global
    batch of size * b rows and sliced to the rank's rows [rank * b,
    (rank + 1) * b): N ranks draw what one process draws at the global
    batch. Scalar draws (the GP's alpha) are whole; a grouped draw (the
    paired G step's) gives the rank its rows of each group; `batch_seed`
    offsets K1's per-sample seed (key seed + b, ops/fused_upscale_noise.py)
    by the rank's first global row. `window` places the rows elsewhere in a
    draw of another size (parallel/sampling.py's sub-batches).
    """

    _window: Optional[Tuple[int, int]] = None

    def __init__(self, seed: int, device="cuda"):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.host_gen = torch.Generator()
        self.host_gen.manual_seed(int(seed))

    def _rows(self, b: int) -> Tuple[int, int]:
        """(rows of the global draw, this rank's first row in it) for a
        draw of b rows on this rank."""
        if self._window is not None:
            return self._window
        group = mesh.active()
        return group.size * b, group.rank * b

    def _sharded(self, draw, shape: Sequence[int]) -> torch.Tensor:
        """draw(shape) of this rank's rows of the global draw."""
        shape = tuple(int(s) for s in shape)
        if not shape:
            return draw(shape)
        total, start = self._rows(shape[0])
        if (total, start) == (shape[0], 0):
            return draw(shape)
        return draw((total,) + shape[1:])[start:start + shape[0]]

    @contextlib.contextmanager
    def window(self, total: int, start: int):
        """Within the body, a batched draw of b rows is rows [start,
        start + b) of a draw of `total` rows, and K1's seeds are offset by
        `start`, whatever the data group."""
        self._window = (int(total), int(start))
        try:
            yield
        finally:
            self._window = None

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return self._sharded(
            lambda s: generate_noise(self.gen, s, "normal"), shape)

    def draw_rows(self, h: int, kind: str, shape: Sequence[int], *args,
                  pad: int = 0) -> torch.Tensor:
        """self.<kind>(shape, *args) of a tensor whose axis -2 has global
        height h + 2 pad, in the layout (h, pad), `shape` this rank's:
        where the spatial axis splits h (parallel/spatial.py), the draw at
        height h + 2 pad, cut to the rank's rows of the layout, so that S
        ranks draw what one process draws; else the draw itself."""
        draw = getattr(self, kind)
        if not spatial.sharded(h):
            return draw(shape, *args)
        shape = tuple(int(s) for s in shape)
        start, n = spatial.rows(h, pad)
        if shape[-2] != n:
            raise ValueError(f"a draw of {shape} for {n} rows of height {h} "
                             f"padded by {pad}")
        return draw(shape[:-2] + (h + 2 * pad, shape[-1]), *args).narrow(
            -2, start, n)

    def grouped_normal(self, shape: Sequence[int], groups: int
                       ) -> torch.Tensor:
        """normal(shape) of a batch made of `groups` equal contiguous parts
        (the paired G step's width-2B forward): under a data group, the
        rank's rows of each part of the global draw."""
        shape = tuple(int(s) for s in shape)
        b = shape[0] // groups
        total, start = self._rows(b)
        if (total, start) == (b, 0):
            return self.normal(shape)
        whole = generate_noise(self.gen, (groups * total,) + shape[1:],
                               "normal")
        return torch.cat([whole[g * total + start:g * total + start + b]
                          for g in range(groups)])

    def uniform(self, shape: Sequence[int] = ()) -> torch.Tensor:
        """U[0, 1) draws on the device: one scalar by default (the GP's
        alpha), or `shape` (GeneratorVAE_nb's Gumbel noise)."""
        return self._sharded(
            lambda s: generate_noise(self.gen, s, "uniform"), shape)

    def bernoulli(self, shape: Sequence[int]) -> torch.Tensor:
        """Bool Bernoulli(0.5) flags on the device (per-sample hflips,
        GeneratorVAE_nb's gate)."""
        return self._sharded(lambda s: generate_noise(
            self.gen, s, "bernoulli", dtype=torch.bool), shape)

    def randint(self, high: int, shape: Sequence[int]) -> torch.Tensor:
        """int64 draws in [0, high) on the device (the video batch's window
        starts)."""
        return self._sharded(lambda s: torch.randint(
            0, int(high), s, generator=self.gen, device=self.device), shape)

    def get_state(self) -> Dict[str, torch.Tensor]:
        """Both generators' states (host byte tensors)."""
        return {"device": self.gen.get_state(),
                "host": self.host_gen.get_state()}

    def set_state(self, state: Dict[str, torch.Tensor]) -> None:
        self.gen.set_state(state["device"])
        self.host_gen.set_state(state["host"])

    def seed(self) -> int:
        """A kernel seed in [0, 2^31 - 1), as networks_2d.py:207 draws it."""
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.host_gen))

    def batch_seed(self, rows: int) -> int:
        """The kernel seed of a batch of `rows` samples: sample b draws from
        seed + b, offset by this rank's first row of the global batch."""
        return self.seed() + self._rows(int(rows))[1]

    def kernel_bits(self, shape: Sequence[int]
                    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Random words for the fused kernel's plain version, or None: the
        kernel (and its plain version) then draw them from the seed by
        Philox. A test overrides this to feed another framework's words."""
        return None


class KeyedNoise(NoiseSource):
    """The JAX package's draws from per-sample PRNG keys, as tensor
    arithmetic that `torch.export` traces (the seed is a graph input).

    `keys` (B, 2) holds sample b's key chain. Each `normal(shape)` splits
    every key into (key, sub), as `key, sub = jax.random.split(key)` before
    each refinement draw (networks_2d.py:214-216, networks_3d.py:224-230
    there), and draws sample b's noise from its sub in JAX's channels-last
    order, (1, H, W, C) or (1, T, H, W, C), then moves the channels to the
    port's axis 1. `bernoulli(shape)` draws GeneratorVAE_nb's gate from
    `gate_keys` (its `kb`, unsplit), also channels-last.

    `shapes`, the shapes of the normal draws to come, in order (a previous
    forward's `drawn_shapes`), draws them all up front through one erfinv
    (jax_prng.normals): the same bits, and one erfinv for a compiler to
    build instead of one per draw.
    """

    def __init__(self, keys: torch.Tensor,
                 gate_keys: Optional[torch.Tensor] = None,
                 shapes: Optional[Sequence[Sequence[int]]] = None):
        self.device = keys.device
        self.keys = keys
        self.gate_keys = gate_keys
        self.drawn_shapes = []
        self._ahead = []
        if shapes:
            subs = [self._next_key() for _ in shapes]
            draws = jax_prng.normals([(sub, self._channels_last(shape))
                                      for sub, shape in zip(subs, shapes)])
            self._ahead = [(tuple(shape), draw)
                           for shape, draw in zip(shapes, draws)]

    def _next_key(self) -> torch.Tensor:
        """The subkey of the next draw: every key splits into (key, sub)."""
        pairs = jax_prng.split(self.keys)
        self.keys = pairs[:, 0]
        return pairs[:, 1]

    @staticmethod
    def _channels_last(shape: Sequence[int]) -> Tuple[int, ...]:
        """One sample's shape in JAX's layout: (1, *spatial, C)."""
        return (1,) + tuple(int(s) for s in shape[2:]) + (int(shape[1]),)

    @staticmethod
    def _to_port(draw: torch.Tensor) -> torch.Tensor:
        """(B, 1, *spatial, C) -> (B, C, *spatial)."""
        return draw.squeeze(1).movedim(-1, 1)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        self.drawn_shapes.append(shape)
        if self._ahead:
            ahead, draw = self._ahead.pop(0)
            if ahead != shape:
                raise ValueError(f"a draw of {shape} where {ahead} was "
                                 "drawn ahead")
            return self._to_port(draw)
        return self._to_port(jax_prng.normal(self._next_key(),
                                             self._channels_last(shape)))

    def bernoulli(self, shape: Sequence[int]) -> torch.Tensor:
        if self.gate_keys is None:
            raise ValueError("KeyedNoise has no gate keys for a Bernoulli "
                             "draw")
        return self._to_port(jax_prng.bernoulli(self.gate_keys,
                                                self._channels_last(shape)))
