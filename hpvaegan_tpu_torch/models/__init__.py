"""Model registry: name -> module class (the port of the JAX package's
`models/__init__.py`). Only the 2D GeneratorHPVAEGAN and WDiscriminator2D
are ported so far."""

from .networks_2d import GeneratorHPVAEGAN, WDiscriminator2D

GENERATORS_2D = {"GeneratorHPVAEGAN": GeneratorHPVAEGAN}
DISCRIMINATORS_2D = {"WDiscriminator2D": WDiscriminator2D}


def _lookup(table, kind: str, name: str, ndim: int):
    if ndim != 2 or name not in table:
        raise NotImplementedError(
            f"{kind} {name!r} ({ndim}D) is not ported yet "
            f"(have {list(table)}, 2D)")
    return table[name]


def get_generator(name: str, ndim: int = 2):
    return _lookup(GENERATORS_2D, "generator", name, ndim)


def get_discriminator(name: str, ndim: int = 2):
    return _lookup(DISCRIMINATORS_2D, "discriminator", name, ndim)
