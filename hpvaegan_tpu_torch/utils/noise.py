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
uninterrupted one would have.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

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
