"""hpvaegan_tpu_torch — the PyTorch/CUDA port of the JAX/TPU package of
this repo, for NVIDIA Hopper (H100).

The JAX package is the reference; this package imports
neither it nor JAX, keeps the same module names where a reader looks for a
counterpart, and reads and writes the same experiment formats (args.txt,
intermediate.json, netG_<k>.ckpt pickled numpy pytrees).

Ported so far: image sampling and SIFID evaluation (eval_image.py),
single-image and single-video training with resume (train_image.py,
train_video.py), video sampling and SVFID evaluation (eval_video.py), the
CSG/SG video baselines (train_video_baselines.py), export and native
serving, and multi-process and data-parallel runs of all five CLIs.
  config.py       typed config, field for field the JAX package's
  utils/          pyramid math, noise sources, saver, media, device choice
  ops/            resize, conv, batchnorm, spectral norm, the fused
                  upscale+noise kernel
  csrc/           hand-written CUDA kernels (built by ops/cuda_build.py)
  models/         GeneratorHPVAEGAN (2D and 3D), GeneratorVAE_nb (2D),
                  GeneratorCSG, GeneratorSG, their critics
  data/           single-image and single-video data
  parallel/       batched sampling; multi-process helpers (multihost.py)
                  and the data-parallel group over ranks (mesh.py)
  training/       the trainers (image, video, baselines) and their steps
  tools/          weight conversion to and from the JAX package's pytrees
  metrics/        SIFID with InceptionV3 block 0, SVFID with C3D
  evaluation.py   hydrate / load / sample / score
"""

__version__ = "0.1.0"
