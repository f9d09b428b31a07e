"""Typed configuration with CLI-flag parity to the reference's scripts.

The port's own copy of the JAX package's `config.py`: the same
fields with the same defaults, the same derived pyramid state and the same
args.txt round-trip, so an experiment written by either package re-hydrates
field for field in the other. Fields that only the JAX package acts on
(`scan_unroll`, `compile_ahead`, `xla_options`) are kept so that args.txt
round-trips whole; `steps_per_call` and `split_step` set the port's
training chunk too (training/chunk.py).
"""

from __future__ import annotations

import ast
import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Config:
    # Load / input / save (reference: train_image.py:219-222)
    netG: str = ""
    netD: str = ""
    intermediate: str = ""
    manualSeed: Optional[int] = None

    # Network hyper-parameters (reference: train_image.py:225-235)
    nc_im: int = 3
    nfc: int = 64
    latent_dim: int = 128
    vae_levels: int = 3
    enc_blocks: int = 2
    ker_size: int = 3
    num_layer: int = 5
    stride: int = 1
    padd_size: int = 1
    generator: str = "GeneratorHPVAEGAN"
    discriminator: str = "WDiscriminator2D"

    # Pyramid parameters (reference: train_image.py:238-241)
    scale_factor: float = 0.75
    noise_amp: float = 0.1
    min_size: int = 32
    max_size: int = 256

    # Optimization hyper-parameters (reference: train_image.py:244-256)
    niter: int = 5000
    lr_g: float = 5e-4
    lr_d: float = 5e-4
    beta1: float = 0.5
    lambda_grad: float = 0.1
    rec_weight: float = 10.0
    kl_weight: float = 1.0
    disc_loss_weight: float = 1.0
    lr_scale: float = 0.2
    train_depth: int = 1
    grad_clip: float = 5.0
    const_amp: bool = False
    train_all: bool = False

    # Dataset (reference: train_image.py:259-263, train_video.py:276-283)
    image_path: str = ""
    video_path: str = ""
    start_frame: int = 0
    max_frames: int = 13
    hflip: bool = False
    img_size: int = 256
    sampling_rates: List[int] = field(default_factory=lambda: [4, 3, 2, 1])
    stop_scale_time: int = -1
    data_rep: int = 1000

    # Main arguments (reference: train_image.py:266-271)
    checkname: str = "debug"
    mode: str = "train"
    print_interval: int = 10
    image_interval: int = 100
    batch_size: int = 1
    visualize: bool = False

    # Eval arguments (reference: eval_image.py:84-93)
    exp_dir: str = ""
    save_path: str = "images"
    num_samples: int = 10
    max_samples: int = 4

    # --- Additions of the JAX package (no reference equivalent) ---
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' for conv compute
    steps_per_call: int = 8  # training iterations per chunk (JAX: per
    #                          dispatch; here CUDA-graph replays)
    scan_unroll: int = 1  # JAX: unroll factor of the iteration scan
    paired_g: bool = False  # GAN-phase G step: recon+fake in one forward
    split_step: bool = False  # one iteration a chunk (JAX: D/G updates as
    #                           separate programs; here an eager loop)
    compile_ahead: bool = True  # JAX: overlap training with the next compile
    pallas_fused_sampling: bool = False  # no-grad moving-stat random-mode
    #                          sampling runs upscale+noise as ONE kernel
    #                          (ops/fused_upscale_noise.py in this package)
    flat_opt: bool = False  # clip+Adam on one flattened buffer
    fused_dg: bool = False  # GAN phase: D and G losses share one fake forward
    bug_compat: bool = False  # replicate reference bugs (frozen GP alpha,
    #                           severed adversarial G gradient, noise amp
    #                           divided by batch_size again)
    xla_options: Optional[dict] = None  # JAX: extra XLA compiler options
    ckpt_interval: int = 0  # mid-scale checkpoint cadence in iterations
    mesh_data: int = 1  # data-parallel axis size
    mesh_sp: int = 1  # spatial axis size
    dist_coordinator: str = ""  # multi-process bootstrap address
    dist_nprocs: int = 0  # process count for explicit-coordinator bootstrap
    dist_procid: int = -1  # this process's id for explicit bootstrap
    device_id: int = 0  # which device to run on
    run_dir: str = "run"  # experiment root (reference hard-codes 'run/')

    # --- Derived state (computed, not user flags) ---
    ar: float = 1.0  # aspect ratio h/w (reference: image.py:29)
    num_scales: int = 0
    stop_scale: int = 0
    scale1: float = 1.0
    scale_factor_init: float = 0.75
    noise_amp_init: float = 0.1
    scale_idx: int = 0
    org_fps: float = 24.0
    fps_lcm: int = 12
    fps: float = 24.0
    td: int = 13
    fps_index: int = 0

    def finalize(self) -> "Config":
        """Compute derived pyramid state (reference: train_image.py:301-305)."""
        self.noise_amp_init = self.noise_amp
        self.scale_factor_init = self.scale_factor
        adjust_scales2image(self.img_size, self)
        if self.stop_scale_time == -1:
            self.stop_scale_time = self.stop_scale
        if self.data_rep < self.batch_size:
            self.data_rep = self.batch_size
        return self

    # --- args.txt round-trip (reference: train_image.py:336-339 / eval_image.py:123-132) ---
    def write_args_txt(self, path: str) -> None:
        with open(path, "w") as f:
            for k, v in sorted(dataclasses.asdict(self).items()):
                if isinstance(v, (str, int, float, tuple, list, bool)):
                    f.write("{}: {}\n".format(k, v))

    @classmethod
    def from_args_txt(cls, path: str, base: Optional["Config"] = None,
                      exceptions: Optional[List[str]] = None) -> "Config":
        cfg = base if base is not None else cls()
        exceptions = exceptions or []
        names = {f.name for f in dataclasses.fields(cls)}
        with open(path, "r") as f:
            for line in f.readlines():
                # strip the edges only: a value may hold spaces (a path)
                parts = [p.strip() for p in line.split(":", 1)]
                if len(parts) != 2 or parts[0] in exceptions or parts[0] not in names:
                    continue
                try:
                    value = ast.literal_eval(parts[1])
                except (ValueError, TypeError, SyntaxError, MemoryError,
                        RecursionError):  # what literal_eval documents
                    value = parts[1]
                setattr(cfg, parts[0], value)
        return cfg


def adjust_scales2image(size: int, cfg) -> None:
    """Pyramid schedule (reference: src/utils/images.py:64-71).

    Defaults 256/32/0.75 -> num_scales=10, stop_scale=9, effective
    scale_factor = (min_size/size)^(1/stop_scale) ~= 0.7937.
    """
    cfg.num_scales = math.ceil(math.log(math.pow(cfg.min_size / size, 1),
                                        cfg.scale_factor_init)) + 1
    scale2stop = math.ceil(math.log(min(cfg.max_size, size) / size,
                                    cfg.scale_factor_init))
    cfg.stop_scale = cfg.num_scales - scale2stop
    cfg.scale1 = min(cfg.max_size / size, 1)
    cfg.scale_factor = math.pow(cfg.min_size / size, 1 / cfg.stop_scale)
