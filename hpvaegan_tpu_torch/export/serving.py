"""`torch.export` of the random-mode sampler for native serving.

The port of the JAX package's `export/stablehlo.py`. The exported program
is the generator's random-mode forward with its weights as constants,
taking
    noise_init : f32 (B, latent_dim, H0, W0), in 3D (B, latent_dim, T0, H0,
                 W0): NCHW / NCTHW, the preprocess .bin contract
    noise_amps : f32 (stop_scale + 2,)
    seed       : i32 ()
and returning f32 (B, nc_im, H, W) (3D: (B, nc_im, T, H, W)) in [-1, 1].

It draws what the JAX serving function draws for the same seed
(utils/jax_prng.py, utils/noise.py::KeyedNoise): PRNGKey(seed) at batch 1,
and at batch B > 1 sample b's chain from split(PRNGKey(seed), B)[b], as the
JAX function's vmap of batch-1 forwards; every sample then splits (kz, kr)
(GeneratorVAE_nb: (kz, kb, kr), its gate drawn from kb) and each noisy
refinement stage splits kr once more. BatchNorm runs in "sample" mode
(ops/norm.py): each sample's own statistics, which is the JAX function's
batch-1 train-mode BatchNorm, in one batched forward; the running
statistics are not touched. K1 does not run here: the JAX function is
train-mode, and its Pallas kernel runs only when not training
(networks_2d.py:193-194 there).

Artifacts: `<prefix>.pt2` (`torch.export.save`; `load_serialized` reads it
back) and `<prefix>.aoti.pt2`, the program compiled by AOTInductor for the
device it was exported on (`compile_native`), which the native runner
(native/runner.cc) loads, as PJRT compiles the JAX export's .mlir.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple, Tuple

import torch
import torch.nn as nn

from .. import models
from ..models.networks_2d import GeneratorVAE_nb
from ..utils import jax_prng, pyramid
from ..utils.device import resolve_device
from ..utils.noise import KeyedNoise

# why the CSG/SG baselines are not served (their export in the JAX package
# cannot run either)
BASELINE_REFUSAL = (
    "the CSG/SG video baselines cannot be served: the JAX package's export "
    "builds a latent_dim-channel noise_init (export/stablehlo.py:76-89 "
    "there), but a baseline's head takes nc_im channels "
    "(networks_3d.py:398-405 there; evaluation.py:118), so its export "
    "fails too")


class InputSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


class ServingModule(nn.Module):
    """forward(noise_init, noise_amps, seed) of a port generator, as the
    JAX package's `make_serving_fn` computes it (module docstring)."""

    def __init__(self, generator: nn.Module):
        super().__init__()
        if generator.cfg.generator in models.BASELINES:
            raise ValueError(BASELINE_REFUSAL)
        self.generator = generator
        # GeneratorVAE_nb splits its key in three (networks_2d.py:195
        # there), GeneratorHPVAEGAN in two
        self.gated = isinstance(generator, GeneratorVAE_nb)
        # the normal draws' shapes of a forward at each batch size, from the
        # first one: later forwards draw them all up front, through one
        # erfinv (the same bits; one erfinv for a compiler to build)
        self.draw_shapes = {}

    def forward(self, noise_init: torch.Tensor, noise_amps: torch.Tensor,
                seed: torch.Tensor) -> torch.Tensor:
        b = noise_init.shape[0]
        key = jax_prng.prng_key(seed)
        keys = key[None] if b == 1 else jax_prng.split(key, b)
        parts = jax_prng.split(keys, 3 if self.gated else 2)
        noise = KeyedNoise(parts[:, -1],
                           gate_keys=parts[:, 1] if self.gated else None,
                           shapes=self.draw_shapes.get(b))
        x, _ = self.generator(noise_init, noise_amps, noise, bn="sample",
                              commit=False)
        self.draw_shapes.setdefault(b, noise.drawn_shapes)
        return x


def serving_input_specs(cfg, ndim: int = 2,
                        batch: int = 1) -> Tuple[InputSpec, ...]:
    """(noise_init, noise_amps, seed) shapes and dtypes, as the JAX
    package's `serving_input_specs`."""
    h0, w0 = pyramid.scale_size_2d(0, cfg.scale_factor, cfg.stop_scale,
                                   cfg.img_size, cfg.ar)
    if ndim == 2:
        z_shape = (batch, cfg.latent_dim, h0, w0)
    else:
        _, td0, _ = pyramid.get_fps_td_by_index(0, cfg.stop_scale_time,
                                                cfg.sampling_rates,
                                                cfg.org_fps, cfg.fps_lcm)
        z_shape = (batch, cfg.latent_dim, td0, h0, w0)
    return (InputSpec(z_shape, torch.float32),
            InputSpec((cfg.stop_scale + 2,), torch.float32),
            InputSpec((), torch.int32))


def io_spec_text(specs) -> str:
    """io_spec.txt, the native runner's sidecar: one line per input, "f32
    1,128,24,33" or "s32" (a scalar), as the JAX export CLI writes it."""
    lines = []
    for spec in specs:
        dt = "f32" if spec.dtype.is_floating_point else "s32"
        lines.append(" ".join([dt] + ([",".join(map(str, spec.shape))]
                                      if spec.shape else [])))
    return "".join(line + "\n" for line in lines)


def export_sampler(cfg, generator: nn.Module, ndim: int = 2, batch: int = 1,
                   device="cuda") -> torch.export.ExportedProgram:
    """`torch.export.export` of ServingModule(generator) on `device` at
    the shapes of `serving_input_specs`. One eager call comes first: it
    fills the resize tables' cache (ops/resize.py) with real tensors, which
    the trace then takes as constants, and records the draws' shapes, which
    the traced forward draws up front through one erfinv."""
    device = resolve_device(device)
    module = ServingModule(generator.to(device)).eval()
    args = tuple(torch.zeros(s.shape, dtype=s.dtype, device=device)
                 for s in serving_input_specs(cfg, ndim, batch))
    with torch.no_grad():
        module(*args)
        return torch.export.export(module, args)


def save_exported(exported: torch.export.ExportedProgram,
                  prefix: str) -> str:
    path = prefix + ".pt2"
    torch.export.save(exported, path)
    return path


def openmp_compiler() -> str:
    """A C++ compiler that links OpenMP, which AOTInductor's build of the
    package's wrapper needs (`-fopenmp`): $CXX where it does, else `g++`
    from PATH (a $CXX may lack libgomp's spec file)."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cc")
        with open(src, "w") as f:
            f.write("#include <omp.h>\n"
                    "int main() { return omp_get_max_threads() < 1; }\n")
        for name in (os.environ.get("CXX"), "g++"):
            cxx = shutil.which(name) if name else None
            if cxx and subprocess.run(
                    [cxx, "-fopenmp", src, "-o", os.path.join(tmp, "probe")],
                    capture_output=True).returncode == 0:
                return cxx
    raise RuntimeError("no C++ compiler that links OpenMP (-fopenmp) in "
                       "$CXX or as g++ on PATH; AOTInductor needs one")


def compile_native(exported: torch.export.ExportedProgram,
                   path: str) -> str:
    """AOTInductor's package of `exported` for its device (`<prefix>.
    aoti.pt2`): the model the native runner loads."""
    from torch._inductor import aoti_compile_and_package, config

    with config.patch({"cpp.cxx": (openmp_compiler(),)}):
        return aoti_compile_and_package(exported, package_path=path)


def load_serialized(path: str) -> torch.export.ExportedProgram:
    """Load a `.pt2` once; reuse it across run_serialized calls."""
    return torch.export.load(path)


def program_device(exported: torch.export.ExportedProgram) -> torch.device:
    """The device of the program's weights: where its inputs must be."""
    for t in list(exported.state_dict.values()) \
            + list(exported.constants.values()):
        if torch.is_tensor(t):
            return t.device
    return torch.device("cpu")


def run_serialized(exported: torch.export.ExportedProgram,
                   *args) -> torch.Tensor:
    """Run the program on (noise_init, noise_amps, seed), numpy or
    tensors; returns the output on the program's device."""
    device = program_device(exported)
    inputs = [torch.as_tensor(a).to(device) for a in args]
    with torch.no_grad():
        return exported.module()(*inputs)


def load_and_run_serialized(path: str, *args) -> torch.Tensor:
    """Python-side runner of a saved export (the native runner's check)."""
    return run_serialized(load_serialized(path), *args)
