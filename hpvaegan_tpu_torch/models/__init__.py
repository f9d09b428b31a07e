"""Model registry: name -> generator class (the port of
the JAX package's `models/__init__.py`). Only the 2D GeneratorHPVAEGAN is
ported so far."""

from .networks_2d import GeneratorHPVAEGAN

GENERATORS_2D = {"GeneratorHPVAEGAN": GeneratorHPVAEGAN}


def get_generator(name: str, ndim: int = 2):
    if ndim != 2 or name not in GENERATORS_2D:
        raise NotImplementedError(
            f"generator {name!r} ({ndim}D) is not ported yet "
            f"(have {list(GENERATORS_2D)}, 2D)")
    return GENERATORS_2D[name]
