"""hpvaegan_tpu_torch — the PyTorch/CUDA port of the JAX/TPU package of
this repo, for NVIDIA Hopper (H100).

The JAX package is the reference; this package imports
neither it nor JAX, keeps the same module names where a reader looks for a
counterpart, and reads and writes the same experiment formats (args.txt,
intermediate.json, netG_<k>.ckpt pickled numpy pytrees).

Ported so far: image sampling and SIFID evaluation (eval_image.py),
single-image training (train_image.py), video sampling and SVFID evaluation
(eval_video.py).
  config.py       typed config, field for field the JAX package's
  utils/          pyramid math, noise sources, saver, media, device choice
  ops/            resize, conv, batchnorm, spectral norm, the fused
                  upscale+noise kernel
  csrc/           hand-written CUDA kernels (built by ops/cuda_build.py)
  models/         GeneratorHPVAEGAN (2D and 3D), WDiscriminator2D
  data/           single-image and single-video data
  parallel/       batched sampling on one device
  training/       the image trainer and its steps
  tools/          weight conversion to and from the JAX package's pytrees
  metrics/        SIFID with InceptionV3 block 0, SVFID with C3D
  evaluation.py   hydrate / load / sample / score
"""

__version__ = "0.1.0"
