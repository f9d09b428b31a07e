"""Model registry: (name, ndim) -> module class (the port of the JAX
package's `models/__init__.py`): GeneratorHPVAEGAN and GeneratorVAE_nb in
2D and 3D, the video baselines GeneratorCSG and GeneratorSG (3D only, as
there), WDiscriminator2D, WDiscriminator3D and WDiscriminatorBaselines.
Of these, only the 2D GeneratorHPVAEGAN has the paired forward of
--paired-g (`reconstruct_pair`; JAX GENERATOR_PAIRS); the others set it to
None, and the G step then runs unpaired."""

from . import networks_2d, networks_3d

GENERATORS = {("GeneratorHPVAEGAN", 2): networks_2d.GeneratorHPVAEGAN,
              ("GeneratorVAE_nb", 2): networks_2d.GeneratorVAE_nb,
              ("GeneratorHPVAEGAN", 3): networks_3d.GeneratorHPVAEGAN,
              ("GeneratorVAE_nb", 3): networks_3d.GeneratorVAE_nb,
              ("GeneratorCSG", 3): networks_3d.GeneratorCSG,
              ("GeneratorSG", 3): networks_3d.GeneratorSG}
DISCRIMINATORS = {("WDiscriminator2D", 2): networks_2d.WDiscriminator2D,
                  ("WDiscriminator3D", 3): networks_3d.WDiscriminator3D,
                  ("WDiscriminatorBaselines", 3):
                      networks_3d.WDiscriminatorBaselines}
# the SinGAN-style video baselines: trained by train_video_baselines
BASELINES = ("GeneratorCSG", "GeneratorSG")


def _lookup(table, kind: str, name: str, ndim: int):
    if (name, ndim) not in table:
        raise NotImplementedError(
            f"{kind} {name!r} ({ndim}D): neither this package nor the JAX "
            f"package has it (have {[f'{n} ({d}D)' for n, d in table]})")
    return table[(name, ndim)]


def get_generator(name: str, ndim: int = 2):
    return _lookup(GENERATORS, "generator", name, ndim)


def get_discriminator(name: str, ndim: int = 2):
    return _lookup(DISCRIMINATORS, "discriminator", name, ndim)
