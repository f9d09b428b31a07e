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
instead (utils/jax_prng.py), for the exported sampler.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

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
    drawing one never waits for the device.
    """

    def __init__(self, seed: int, device="cuda"):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.host_gen = torch.Generator()
        self.host_gen.manual_seed(int(seed))

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return generate_noise(self.gen, shape, "normal")

    def uniform(self, shape: Sequence[int] = ()) -> torch.Tensor:
        """U[0, 1) draws on the device: one scalar by default (the GP's
        alpha), or `shape` (GeneratorVAE_nb's Gumbel noise)."""
        return generate_noise(self.gen, shape, "uniform")

    def bernoulli(self, shape: Sequence[int]) -> torch.Tensor:
        """Bool Bernoulli(0.5) flags on the device (per-sample hflips,
        GeneratorVAE_nb's gate)."""
        return generate_noise(self.gen, shape, "bernoulli", dtype=torch.bool)

    def randint(self, high: int, shape: Sequence[int]) -> torch.Tensor:
        """int64 draws in [0, high) on the device (the video batch's window
        starts)."""
        return torch.randint(0, int(high), tuple(int(s) for s in shape),
                             generator=self.gen, device=self.device)

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
    """

    def __init__(self, keys: torch.Tensor,
                 gate_keys: Optional[torch.Tensor] = None):
        self.device = keys.device
        self.keys = keys
        self.gate_keys = gate_keys

    @staticmethod
    def _channels_last(shape: Sequence[int]) -> Tuple[int, ...]:
        """One sample's shape in JAX's layout: (1, *spatial, C)."""
        return (1,) + tuple(int(s) for s in shape[2:]) + (int(shape[1]),)

    @staticmethod
    def _to_port(draw: torch.Tensor) -> torch.Tensor:
        """(B, 1, *spatial, C) -> (B, C, *spatial)."""
        return draw.squeeze(1).movedim(-1, 1)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        pairs = jax_prng.split(self.keys)
        self.keys = pairs[:, 0]
        return self._to_port(jax_prng.normal(pairs[:, 1],
                                             self._channels_last(shape)))

    def bernoulli(self, shape: Sequence[int]) -> torch.Tensor:
        if self.gate_keys is None:
            raise ValueError("KeyedNoise has no gate keys for a Bernoulli "
                             "draw")
        return self._to_port(jax_prng.bernoulli(self.gate_keys,
                                                self._channels_last(shape)))
