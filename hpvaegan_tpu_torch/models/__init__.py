"""Model registry: (name, ndim) -> module class (the port of the JAX
package's `models/__init__.py`). Ported so far: GeneratorHPVAEGAN in 2D and
3D, WDiscriminator2D and WDiscriminator3D."""

from . import networks_2d, networks_3d

GENERATORS = {("GeneratorHPVAEGAN", 2): networks_2d.GeneratorHPVAEGAN,
              ("GeneratorHPVAEGAN", 3): networks_3d.GeneratorHPVAEGAN}
DISCRIMINATORS = {("WDiscriminator2D", 2): networks_2d.WDiscriminator2D,
                  ("WDiscriminator3D", 3): networks_3d.WDiscriminator3D}


def _lookup(table, kind: str, name: str, ndim: int):
    if (name, ndim) not in table:
        raise NotImplementedError(
            f"{kind} {name!r} ({ndim}D) is not ported yet "
            f"(have {[f'{n} ({d}D)' for n, d in table]})")
    return table[(name, ndim)]


def get_generator(name: str, ndim: int = 2):
    return _lookup(GENERATORS, "generator", name, ndim)


def get_discriminator(name: str, ndim: int = 2):
    return _lookup(DISCRIMINATORS, "discriminator", name, ndim)
