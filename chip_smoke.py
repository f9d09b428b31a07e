#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hpvaegan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each of which exits non-zero on a failed check:
  1. build   the CUDA kernel from csrc/ (nvcc, sm_90a)
  2. kernel  K1 (fused upscale+noise) against its plain PyTorch version at
             the nine full-width stage shapes, B=64, bit for bit; its noise
             statistics; times of the kernel (CUDA events over 20 calls, and
             its device time from a profiler window over 20 more), the plain
             version and one PyTorch yardstick (F.interpolate + randn FMA,
             never used by the port)
  3. sampler the kernel's main path: generate_samples(train_mode=False) with
             pallas_fused_sampling, 64 samples of the full-width model
             (img 256, nfc 64, num_layer 5, latent 128, 10 scales); K1 must
             launch 9 times per forward; kernel path == plain path at amps 0
  4. CLI     python -m hpvaegan_tpu_torch.eval_image on an experiment dir
             written in the JAX package's format (args.txt,
             intermediate.json, netG_9.ckpt from a numpy seed): per-sample
             BatchNorm sampling, PNGs, SIFID
  5. step    one GAN-scale training iteration (D then G) of a tiny config
             on the card with TF32 off against the same iteration on the
             CPU, from the same weights and draws (tools/step_parity.py):
             metrics to rtol 1e-4, gradients, BatchNorm and spectral-norm
             state to atol 1e-4
  6. train   the training CLI (hpvaegan_tpu_torch.train_image.main) at full
             width, TF32 off and deterministic cuDNN (phase 13 resumes
             against it), 10 scales of air_balloons.jpg, 4 iterations each: the
             checkpoints, intermediate.json and finite logged losses; then
             the eval CLI scores the experiment (finite SIFID). Training
             runs no kernel: K1's count stays 0 over the run
  7. timing  train iterations at scale 9 (GAN, 192x257) and scale 2 (VAE)
             at full width, batch 1: steps/s over 10 iterations after 3
             warm-up ones, D-step and G-step ms (synchronised), and one
             profiled iteration (device busy ms, idle share, ms by group,
             top 8 kernels, top 8 operators with their input shapes); then
             scale 9 once more with cudnn.benchmark on (the trainer keeps
             it off), and once with TF32 off and deterministic cuDNN
  8. video   the video main path: generate_samples(ndim=3) of the full-width
             3D model (Config() defaults, data/vids/balloons_pan.avi, 13
             frames, sampling rates 4 3 2 1: 10 scales 4x24x33 ..
             13x192x257), 64 samples a batch with z at the eval time depth
             13, in both BatchNorm modes: shape, range, K1 launches 0,
             videos/s and frames/s, peak memory, one profiled forward, once
             more with cudnn.benchmark on; then a tiny 3D config on the card
             with TF32 off against the CPU from the same draws (atol 1e-4)
  9. video CLI  python -m hpvaegan_tpu_torch.eval_video on a JAX-format
             video experiment dir (netG_9.ckpt from a numpy seed), 10
             samples: finite SVFID, random_samples.npy, real_full_scale.npy,
             the GIFs and unfold PNGs, metrics.json
 10. video step  phase 5 for the 3D networks: one VAE-scale G step and one
             GAN-scale iteration of a tiny 3D config (synthetic.avi, 5
             frames, rates 2 1, hflip, batch 2) on the card with TF32 off
             against the CPU from the same draws
 11. video train  the video training CLI (hpvaegan_tpu_torch.train_video.
             main) at full width, TF32 off and deterministic cuDNN (phase
             13 resumes against it), Config() defaults on balloons_pan.avi (13
             frames, rates 4 3 2 1), 10 scales x 2 iterations: the
             checkpoints, intermediate.json, finite logged losses, K1's
             count 0, seconds per scale; then the eval_video CLI scores the
             experiment (finite SVFID)
 12. video timing  phase 7's timing of train iterations for the 3D model at
             scale 9 (GAN, 13x192x257) and scale 2 (VAE, 4x38x51), batch
             1, with the device time of the GP double backward's
             convolutions by shape; iteration counts cut where one
             iteration takes over 1 s; then scale 9 with TF32 off and
             deterministic cuDNN
 13. resume  phase 6's and phase 11's runs (which run with TF32 off and
             deterministic cuDNN) are the uninterrupted ones: the same CLI
             runs again with --ckpt-interval, killed through step_callback
             mid-scale at scale 9, and resumes from its inflight marker;
             the image run also once from a finalized marker (killed at the
             start of scale 5). netG_9 of each resumed run against the
             uninterrupted one (atol 1e-4; 0 expected), the resumed tail's
             seconds, inflight_9.ckpt's size and write time; the final
             intermediate.json holds no "inflight" and no "key"
 14. VAE_nb  the 2D GeneratorVAE_nb at full width: one 64-sample
             moving-stat forward with pallas_fused_sampling (K1 launches 9
             times; kernel path == plain path at amps 0, TF32 off),
             samples/s in both BatchNorm modes; one tiny iteration card vs
             CPU; train_image --generator GeneratorVAE_nb (10 scales x 2
             iterations, seconds per scale), then eval_image (finite SIFID)
 15. baselines  the CSG/SG video baselines (WDiscriminatorBaselines):
             (a) one tiny iteration of each (phase 10's config) card vs
             CPU, TF32 off; (b) each generator's 64-sample per-sample-BN
             generate_samples(ndim=3) at full width from a numpy-seed
             JAX-format netG_9 (10 stages): shape, range, sub-batches [21,
             21, 22], videos/s, peak GB, conv TFLOP, K1 launches 0, one
             profiled forward; (c) train_video_baselines for GeneratorCSG at
             full width, 10 scales x 2 iterations, TF32 off and
             deterministic cuDNN: the checkpoints at every scale, Z_init.npy,
             finite losses, seconds per scale, scale 9's D and G step ms,
             then eval_video (finite SVFID); scale 9's D and G step ms also
             with PyTorch's defaults; (d) (c)'s run killed after iteration 1
             of scale 9 and resumed from inflight_9.ckpt: netG_9 against
             (c)'s (atol 1e-4; 0 expected). GeneratorSG runs (a) and (b)
             only, to keep the script's time in budget
 16. flags  the training flags (--compute-dtype bfloat16, --fused-dg,
             --paired-g, --flat-opt, --visualize, --profile-dir): (a) one
             tiny GAN-scale iteration per flag card vs CPU (TF32 off):
             --fused-dg in 2D, 3D and CSG, --paired-g and --flat-opt in 2D
             at atol 1e-4, bf16 in 2D and 3D within BF16_CARD_TOL; (b) scale
             9 at full width, batch 1, 2D and 3D, with PyTorch's defaults:
             f32, bf16, fused-dg, bf16+fused-dg (2D also paired-g,
             flat-opt):
             steps/s, D and G (or fused-iteration) ms, peak GB,
             and for bf16 one profiled iteration's GP image-sized
             convolutions with their kernels and TFLOP/s; (c) the main path
             train_video --compute-dtype bfloat16 --fused-dg at full width,
             10 scales x 2, then eval_video (finite SVFID, float32 samples,
             K1 launches 0), and train_image --paired-g --flat-opt
             --visualize --image-interval 2 --profile-dir, 10 x 4 (the
             img/ files, one trace with CUDA kernel events)
 17. on-device FID and interop  (a) per-sample (mu, sigma) of tiny
             features on the card (TF32 off) against the CPU (rtol 1e-5);
             eval_image and eval_video --on-device-fid, 64 samples, on
             JAX-format experiments of the full-width image and video
             models (numpy-seed netG_9): finite score, metrics.json with
             on_device_fid true and num_samples 64, random_samples.npy of
             max_samples (4), K1 launches 0, three copies to the host;
             seconds split into sampling, features + statistics and
             Frechet, peak GB, bytes to the host beside the host path's
             samples, and the same CLI's seconds on the host path (whose
             SVFID, from the same 64 clips, must agree to rtol 1e-3); (b) a .pth and a MindSpore netG_9 of the full-width
             image model (the port's own t2m_HPVAEGAN): load_generator from
             each gives 8 samples equal bit for bit to the pickled pytree's
             (deterministic cuDNN), then train_image --netG <MindSpore
             netG_9> with a MindSpore netD_8 beside it retrains scale 9
             for 2 iterations
 18. export and serving  (a) a tiny ServingModule (2D at batch 2, 3D at
             batch 1) on the card (TF32 off) against the CPU, same seed
             (atol 1e-4); (b) `python -m hpvaegan_tpu_torch.export`, 8
             noise bins each, on JAX-format experiments of the full-width
             image (air_balloons.jpg's aspect) and video models
             (numpy-seed netG_9) and of a tiny image model, the three
             processes side by side: export and AOTInductor compile
             seconds, peak GB, artifact MB. The native runner
             (native/runner.cc, built with g++ beside phase 1) on the tiny
             model's bins against its ExportedProgram (TF32 off, atol
             1e-4); at full width, the ExportedProgram against the eager
             ServingModule (atol 1e-4), the runner against the same
             package run in this process (atol 1e-4) and against the
             ExportedProgram (FULL_WIDTH_COMPILED_TOL, beside the
             model's own response to a one-ulp change of its input), its
             warm latency in float32 and with TF32 beside the eager
             module's (h2d + forward + d2h); postprocess (finite SIFID /
             SVFID); K1 launches 0 in this process's serving path; (c)
             beside the export CLIs, a process that exports the serving
             module's draw chain (its key splits and KeyedNoise's normals
             at every refinement stage of the full-width image and video
             models, drawn up front as the traced serving forward draws
             them), compiles it with AOTInductor for the card and holds
             its draws at three seeds to utils/jax_prng.py's numpy path
             (XLA:CPU's arithmetic) bit for bit (that process starts
             with the export CLIs and is joined before anything is
             timed after them; no phase before 18 runs beside it, and
             phase 22 (a)'s two device-bound scale-9 cases run in this
             process while the CLIs compile)
 19. data parallel  (a) the multi-process helpers and the data group's
             collectives under NCCL as one rank on the card: agree_*,
             broadcast_str (raising for a long string), to_host, sync,
             batch-statistics BatchNorm's double backward through the
             all-reduce, and one full-width scale-9 iteration over the
             one-rank group against no group (TF32 off; the first
             iteration's metrics and gradients within DP_TRAIN_REL, the
             parameters and running statistics after 4 reported: Adam's
             first update turns a gradient that is zero up to rounding
             into +-lr, and the random full-width model amplifies
             rounding); then, in the same one-rank NCCL group, phase 22
             (a)'s graph against eager at full-width 2D scale 9 and 3D
             scale 2 (16 iterations at --steps-per-call 8): the chunk a
             graph ("graph (1 NCCL rank)") whose capture issued as many
             of the group's collectives as an eager iteration and no host
             sync, equal to the eager run bit for bit;
             (b) two ranks on the card over gloo (NCCL takes one card per
             rank), each a `chip_smoke.py --dp-worker` process, against
             this process at the same global batch, TF32 off: 4
             full-width scale-9 iterations at batch 2 (the ranks'
             parameters and metrics bit-equal; against one process as in
             (a); steps/s of both over iterations 2-3, and iteration 4's
             device ms in the gradients' exchange, its phases d.exchange
             and g.exchange), eval_image --on-device-fid of 64 samples of
             the full-width image model sharded over the ranks (the
             same SIFID on both, rtol 1e-3 of one process's), the
             moving-stat sampler with pallas_fused_sampling, 2 x 32
             against 1 x 64 (K1 launching 9 times on each rank, seeds
             offset by the rank's first row; max abs err 1e-4), and the
             full-width video model's per-sample-BN sampler, 2 x 32
             against 1 x 64, which one process splits into two
             sub-batches of 32 (each rank runs both, one on none of its
             rows, for the draws; max abs err 1e-4);
             (c) planted faults: (b)'s first iteration on two ranks with
             the gradients not averaged, BatchNorm's statistics not
             reduced, or every rank drawing the first rows (another
             rank's draws), each of which DP_TRAIN_REL must catch
 20. spatial mesh  --mesh-sp 2 (parallel/spatial.py): (a) two ranks on the
             card over gloo (`chip_smoke.py --sp-worker` processes), each
             on its rows of H, against this process at the same batch of
             1, TF32 off: 4 full-width scale-9 iterations of the 2D model
             (192x257; heights 24 .. 96 and 192 split, 121 and 153 whole):
             the ranks' parameters and metrics bit-equal, the first
             iteration's metrics and gradients within DP_TRAIN_REL of one
             process, steps/s of both, the device ms of a rank's
             iteration in the gradients' exchange, peak GB per rank beside one process's, and the
             heights the sharded convolutions ran on (96 + 2 at scale 9);
             K1 launches 0; (b) the same for the 3D model
             at scale 9 (13x192x257), 2 iterations; (c) planted faults:
             (a)'s first iteration with the halo rows zeroed, BatchNorm not
             summed over the spatial ranks, or every rank drawing the first
             rows of H, each of which DP_TRAIN_REL must catch; (d) the
             CSG/SG baselines against WDiscriminatorBaselines at full
             width on --mesh-sp 4: four gloo ranks (`chip_smoke.py
             --spb-worker` processes) against this process at batch 1,
             2 scale-9 iterations per generator, TF32 off (every stage of
             the body runs, heights 24 48 60 76 96 192 split into 4 and 30
             38 121 153 whole; the padded stages' and the critic's edge
             ranks hold their pad rows, 6 and 7 more than the middle
             ranks' 48 at scale 9): the ranks' parameters and metrics
             bit-equal, the first iteration's metrics and gradients within
             DP_TRAIN_REL of one process, steps/s of both, each rank's
             device ms of an iteration in the gradients' exchange and its
             collectives' number, peak
             GB per rank beside one process's, the heights each rank's
             sharded convolutions ran on (the edge ranks' differ from the
             middle ranks'), K1 launches 0; and the first CSG iteration
             with BatchNorm of a padded layout counted as equal shards,
             which DP_TRAIN_REL must catch
 21. VAE_nb 3D  the 3D GeneratorVAE_nb at full width: (a) one tiny
             VAE-scale G step and one GAN-scale iteration (phase 10's
             config) card vs CPU, TF32 off (atol 1e-4); (b)
             generate_samples(ndim=3) of 64 clips at phase 8's full-width
             video config from a numpy-seed JAX-format netG_9 (the gate at
             the eval time depth 13): shape, range, sub-batches, videos/s
             beside phase 8's GeneratorHPVAEGAN rate, peak GB, K1 launches
             0; (c) train_video --generator GeneratorVAE_nb at full width,
             10 scales x 2 iterations, TF32 off and deterministic cuDNN
             (phase 11's checks, seconds per scale), then eval_video
             (finite SVFID)
 22. chunk  the training chunk (training/chunk.py, --steps-per-call):
             (a) graph against eager at full width, batch 1, TF32 off and
             deterministic cuDNN, from the same weights and seed: 2D and
             3D GeneratorHPVAEGAN at scales 2 (VAE) and 9 (GAN),
             GeneratorCSG at scale 9 and 2D bf16 + --fused-dg + --flat-opt
             at scale 9, each 16 iterations as --steps-per-call 8 (the
             first chunk eager on the capture stream, then 8 replays of
             the captured iteration) and as --split-step eager iterations
             (the first 8 run once, the eager run continues from a copy
             of their end): G's and D's parameters and buffers, both
             optimizers' states and the NoiseSource's state (atol 1e-4;
             equal bit for bit expected), steps/s and the idle share of
             each mode, capture seconds, the graph pool's GB, peak GB
             (the 3D and CSG scale-9 cases, device-bound, run beside
             phase 18's export CLIs, when this process would only wait);
             (b) the main path, train_image at full width, 10 scales x 16
             iterations, --steps-per-call 8 --ckpt-interval 8
             --print-interval 4, TF32 off and deterministic cuDNN: 10
             captures and 80 replays, the logbook at the JAX trainer's
             iterations (8 and 16 of every scale); a second run resumed
             from the first one's finalized scale-8 marker, killed after
             the first chunk of scale 9 and resumed from inflight_9.ckpt
             (netG_9 against the uninterrupted run's, atol 1e-4; 0
             expected), and a resume at --steps-per-call 3 refused; K1
             launches 0
The train CLIs of phases 6-21 run with --split-step: one eager iteration a
chunk, the per-iteration loop that those phases measured and hold.
Then it prints the kernels' JSON line, the card's name and power limit as
nvidia-smi gives them, and last {"ok": true, "device": {...}}.

    python3 chip_smoke.py --cards 4    # four cards of one host

runs the mesh as it is deployed instead, and nothing else: four NCCL
ranks, one card each (`chip_smoke.py --cards-worker` processes, one
process group), against this process on card 0 at the same global batch,
TF32 off and deterministic cuDNN; on fewer cards it fails. Each training
case builds the full-width model at scale 9 twice from one seed and runs
chunks of 8 (2D) or 2 (3D) iterations: iteration 1 eagerly on the capture
stream (its metrics and gradients within DP_TRAIN_REL of one process's,
the ranks bit-equal), then, the state set back in place, the capture and
replay of iteration 1 (bit-equal to the eager one: what (f) reads), the
graph's other iterations against as many --split-step iterations of the
second state (bit for bit), steps/s of both modes and of one process,
the collectives captured and those of an eager iteration, no host sync
in the capture, each mode's share in NCCL's kernels from a profiler
window, peak GB per rank and the heights the sharded convolutions ran
on. Graph and eager must be equal bit for bit under NCCL's defaults.
  (a) 2D scale 9 (192x257) at --mesh-data 4 (batch 4), --mesh-sp 4
      (batch 1, 48 + 2 rows a convolution) and --mesh-data 2 --mesh-sp 2
      (batch 2, 96 + 2)
  (b) the same for the 3D model at scale 9 (13x192x257); one process
      runs it eagerly (at batch 4 a graph's pool beside the eager state
      would not fit the card)
  (c) GeneratorCSG against WDiscriminatorBaselines at --mesh-sp 4, batch
      1, in unequal padded shards (the edge ranks' heights differ from
      the middle ranks')
  (d) train_image --mesh-data 2 --mesh-sp 2 --batch-size 2 under
      torchrun (10 scales x 16 iterations, --steps-per-call 8) and
      train_video_baselines --mesh-sp 4 with explicit --dist-* flags and
      no --device-id (10 scales x 4, --steps-per-call 2): one experiment
      dir, "graph (4 NCCL ranks)" at every scale, bit for bit the same
      run under --split-step (every amp, every scale's G and D on every
      rank), the ranks bit-equal at every scale's end, scale 1's amp
      within DP_TRAIN_REL of one process's; the later amps and netGs
      reported against one process beside one process whose inputs are
      one ulp up; train_image with the gradients not averaged must fail
      a bar
  (e) eval_image and eval_video --mesh-data 4 --on-device-fid at 64
      samples (the same score on every rank, rtol 1e-3 of one process),
      and the moving-stat sampler with pallas_fused_sampling, 4 x 16
      against 1 x 64 (K1 launching 9 times on each rank; max abs err
      1e-4)
  (f) faults planted in graph mode: the gradients not averaged and
      BatchNorm not reduced (--mesh-data 4), a halo taken from the wrong
      neighbour (--mesh-sp 4): the graph's iteration 1 must exceed
      DP_TRAIN_REL
It prints one JSON line a case, the cards' names and power limits, and
last the same {"ok": true, ...} line. `--cards 4 --clis-only` runs (d)
alone.

Weights are random (numpy seed), He-normal convs so activations keep unit
scale through the stacks. Nothing here imports JAX or the JAX package.
"""

import atexit
import contextlib
import dataclasses
import io
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# the pl.pallas_call that K1 replaces
K1_REPLACES = "hpvaegan_tpu/ops/pallas/upsample_noise.py:111"
SEED = 0
BATCH = 64
SERVE_BINS = 8  # phase 18's noise bins per experiment
# phase 18: the compiled program (AOTInductor's fused kernels) against the
# eager ExportedProgram at full width. Both are float32 but round in
# another order, and the random full-width models amplify one rounding a
# thousandfold: moving each element of noise_init by one ulp moves the
# output by 2.0e-3 (2D) and 1.9e-3 (3D) on an H100, and the compiled
# program differs from the eager one by 3.5e-3 and 1.9e-3. The runner is
# held to the package run in this process (the same compiled code) and,
# on the tiny model, to the ExportedProgram, both at 1e-4.
FULL_WIDTH_COMPILED_TOL = 1e-2
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, same source
H100_TF32_FLOPS = 495e12  # TF32 on the tensor cores, dense, same source
# f32 operations per K1 output element: 3 lerps (sub, mul, add each),
# Box-Muller (2 int->float, 2 add, 2 mul, 2 clamp, log, mul, sqrt, mul,
# cos, mul) and amp * noise + clean; the Philox integer work is not counted
K1_FLOPS_PER_OUT = 9 + 14 + 2


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` calls after one warm call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(torch, calls, reps):
    """Mean device time of the K1 launch in each of `calls`, from one
    profiler window over `reps` calls of each in turn: the kernel's own
    time, which CUDA events over back-to-back calls hide behind host time
    on small stages. One window for all: with a new profiler per stage,
    the card's kernel records went missing after a few stages."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.elapsed_us())
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "upsample_noise" in e.name)
    check(len(spans) == reps * len(calls),
          f"the profiler saw {len(spans)} K1 launches of "
          f"{reps * len(calls)}")
    return [sum(us for _, us in spans[i * reps:(i + 1) * reps]) / reps / 1e3
            for i in range(len(calls))]


def full_width_config(**kw):
    from hpvaegan_tpu_torch.config import Config

    cfg = Config(niter=1, num_samples=BATCH, **kw).finalize()
    cfg.scale_idx = cfg.stop_scale
    cfg.Noise_Amps = [1.0] + [0.3 * 0.8 ** k for k in range(cfg.stop_scale)]
    return cfg


def random_jax_checkpoint(cfg, seed, ndim=2):
    """A full-width generator (2D or 3D) at scale stop_scale as the JAX
    package's netG_<k>.ckpt pytree, every tensor drawn with numpy."""
    import numpy as np

    from hpvaegan_tpu_torch.models import get_generator
    from hpvaegan_tpu_torch.tools.convert import to_jax

    rng = np.random.RandomState(seed)
    gen = get_generator(cfg.generator, ndim)(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage()
    sd = {}
    for key, ref in gen.state_dict().items():
        shape = tuple(ref.shape)
        if key.endswith("running_var"):
            a = np.ones(shape)
        elif key.endswith("norm.weight"):
            a = 1.0 + 0.02 * rng.randn(*shape)
        elif len(shape) >= 4:  # conv weights, OIHW or OIDHW
            a = rng.randn(*shape) * math.sqrt(2.0 / np.prod(shape[1:]))
        elif key.endswith(("weight_u", "weight_v")):
            a = rng.randn(*shape)
            a /= np.linalg.norm(a)
        else:  # biases, BN beta and running_mean
            a = np.zeros(shape)
        sd[key] = a.astype(np.float32)
    params, state = to_jax(sd, ndim)
    return {"params": params, "state": state}


def load_port_generator(cfg, ckpt, device, ndim=2):
    from hpvaegan_tpu_torch.models import get_generator
    from hpvaegan_tpu_torch.tools.convert import from_jax

    gen = get_generator(cfg.generator, ndim)(cfg)
    while len(gen.body) < len(ckpt["params"]["body"]):
        gen.init_next_stage()
    gen.load_state_dict(from_jax(ckpt["params"], ckpt["state"], ndim))
    return gen.to(device).eval()


def phase_kernel(torch, F, k1, sizes):
    """K1 vs its plain version at the 9 stage shapes of one forward."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows, calls, err = [], [], 0.0
    for i in range(len(sizes) - 1):
        h_in, h_out = sizes[i], sizes[i + 1]
        hw = (h_out, h_out)
        x = torch.randn(BATCH, 3, h_in, h_in, device=dev, generator=g)
        seed = 1000 + i
        clean, noised = k1.fused_upscale_noise_2d(x, hw, 0.7, seed)
        bits = k1.philox_bits(seed, (BATCH, 3) + hw, dev)
        p_clean, p_noised = k1.fused_upscale_noise_2d_plain(x, hw, 0.7, bits)
        torch.cuda.synchronize()
        e_clean = float((clean - p_clean).abs().max())
        e_noised = float((noised - p_noised).abs().max())
        # bit for bit: same tables, same op order, accurate libm, no FMA
        check(torch.equal(clean, p_clean), f"stage {i}: clean differs by "
              f"{e_clean}")
        check(torch.equal(noised, p_noised), f"stage {i}: noised differs by "
              f"{e_noised}")
        err = max(err, e_clean, e_noised)

        c0, n0 = k1.fused_upscale_noise_2d(x, hw, 0.0, seed)
        check(torch.equal(c0, n0), f"stage {i}: amp 0 changed the output")
        zeros = torch.zeros_like(x)
        c1, n1 = k1.fused_upscale_noise_2d(zeros, hw, 1.0, seed)
        noise = n1 - c1
        mean, std = float(noise.mean()), float(noise.std())
        check(abs(mean) < 0.05 and abs(std - 1) < 0.05,
              f"stage {i}: noise mean {mean} std {std}")
        _, again = k1.fused_upscale_noise_2d(zeros, hw, 1.0, seed)
        check(torch.equal(again, n1), f"stage {i}: same seed, other output")
        check(float((noise[0] - noise[1]).abs().max()) > 0,
              f"stage {i}: two samples drew the same noise")
        _, other = k1.fused_upscale_noise_2d(zeros, hw, 1.0, seed + 1)
        check(float((other - n1).abs().max()) > 0,
              f"stage {i}: a new seed left the noise unchanged")

        ms = cuda_ms(lambda: k1.fused_upscale_noise_2d(x, hw, 0.7, seed), 20)
        calls.append(lambda x=x, hw=hw, seed=seed:
                     k1.fused_upscale_noise_2d(x, hw, 0.7, seed))
        plain_ms = cuda_ms(lambda: k1.fused_upscale_noise_2d_plain(
            x, hw, 0.7, k1.philox_bits(seed, (BATCH, 3) + hw, dev)), 5)

        def library():
            up = F.interpolate(x, size=hw, mode="bilinear", align_corners=True)
            return up, up + 0.7 * torch.randn_like(up)

        library_ms = cuda_ms(library, 20)
        n_in, n_out = x.numel(), BATCH * 3 * h_out * h_out
        nbytes = 4 * (n_in + 2 * n_out) + 12 * 2 * h_out  # + index tables
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = n_out * K1_FLOPS_PER_OUT / H100_F32_FLOPS * 1e3
        rows.append(dict(stage=i + 1, h_in=h_in, h_out=h_out, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                         mbytes=nbytes / 1e6, max_abs_err=max(e_clean, e_noised)))
    for row, dev_ms in zip(rows, kernel_device_ms(torch, calls, 20)):
        row["device_ms"] = dev_ms
        print(f"  K1 stage {row['stage']}: {row['h_in']}->{row['h_out']} ms "
              f"{row['ms']:.4f} device_ms {dev_ms:.4f} plain "
              f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} bound "
              f"{row['bound_ms']:.4f} err {row['max_abs_err']:.3g}",
              flush=True)
    return rows, err


def phase_sampler(torch, k1, ckpt):
    """The kernel's main path at full width, 64 samples, train_mode=False."""
    import numpy as np

    from hpvaegan_tpu_torch.evaluation import generate_samples

    dev = torch.device("cuda")
    cfg = full_width_config(pallas_fused_sampling=True)
    gen = load_port_generator(cfg, ckpt, dev)
    generate_samples(cfg, gen, train_mode=False, seed=SEED)  # warm-up

    k1.fused_upscale_noise_2d.launches = 0
    out = generate_samples(cfg, gen, train_mode=False, seed=SEED + 1)
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == cfg.stop_scale,
          f"K1 launched {launches} times in one forward, want {cfg.stop_scale}")
    check(out.shape == (BATCH, 257, 257, 3), f"sample shape {out.shape}")
    check(bool(np.isfinite(out).all()), "non-finite samples")
    check(float(np.abs(out).max()) <= 1.0, "samples outside [-1, 1]")
    print(f"  main path: K1 launches in one 64-sample forward: {launches}; "
          f"samples {out.shape} in [{out.min():.3f}, {out.max():.3f}], "
          f"std {out.std():.4f}", flush=True)

    timings = {}
    for name, fused, train in (("fused_moving", True, False),
                               ("plain_moving", False, False),
                               ("per_sample_bn", False, True)):
        cfg.pallas_fused_sampling = fused
        generate_samples(cfg, gen, train_mode=train, seed=SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in range(3):
            generate_samples(cfg, gen, train_mode=train, seed=SEED + r)
        timings[name] = 3 * BATCH / (time.perf_counter() - t0)
    cfg.pallas_fused_sampling = True
    print("  samples/s (64-sample batches, host numpy out): "
          + json.dumps(timings), flush=True)

    # kernel path vs plain path at amps 0, TF32 off: same z, same samples
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    mm_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg.Noise_Amps = [1.0] + [0.0] * cfg.stop_scale
    fused = generate_samples(cfg, gen, train_mode=False, seed=SEED + 7)
    cfg.pallas_fused_sampling = False
    plain = generate_samples(cfg, gen, train_mode=False, seed=SEED + 7)
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cuda.matmul.allow_tf32 = mm_tf32
    diff = float(np.abs(fused - plain).max())
    check(diff <= 1e-4, f"kernel path and plain path differ by {diff}")
    print(f"  kernel path vs plain path at amps 0 (TF32 off): max |diff| "
          f"{diff:.3g}", flush=True)
    return launches, timings, profile_forward(torch, cfg, gen)


def profile_forward(torch, cfg, gen):
    """Device time by kernel of one fused moving-stat forward (host numpy
    out included), from the profiler's device-side events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hpvaegan_tpu_torch.evaluation import generate_samples

    cfg.pallas_fused_sampling = True
    cfg.Noise_Amps = [1.0] + [0.3 * 0.8 ** k for k in range(cfg.stop_scale)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate_samples(cfg, gen, train_mode=False, seed=SEED)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, groups, k1_ms = {}, {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if "upsample_noise" in e.name:
            k1_ms.append(round(ms, 4))
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        low = e.name.lower()
        group = ("k1" if "upsample_noise" in low else
                 "memcpy" if "memcpy" in low else
                 "conv" if any(k in low for k in ("conv", "gemm", "xmma",
                                                  "cudnn", "sm90", "sm80"))
                 else "other")
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(by_name.values())
    check(groups.get("k1", 0.0) > 0, "the profile shows no K1 device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    summary = {"wall_ms": round(wall_ms, 3), "device_busy_ms": round(busy, 3),
               "idle_share": round(1 - busy / wall_ms, 4),
               "groups_ms": {k: round(v, 3) for k, v in sorted(groups.items())},
               "k1_device_ms_by_stage": k1_ms,
               "top_ms": [[k[:70], round(v, 3)] for k, v in top]}
    print("  profile of one forward: " + json.dumps(summary), flush=True)
    return summary


def phase_cli(torch, k1, ckpt):
    """The user's eval CLI on a JAX-format experiment dir (default mode:
    per-sample BatchNorm, which runs no kernel)."""
    import numpy as np

    from hpvaegan_tpu_torch import eval_image

    image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
    check(os.path.isfile(image), f"missing {image}")
    cfg = full_width_config(image_path=image)
    with tempfile.TemporaryDirectory(prefix="hpv_smoke_") as exp:
        write_experiment(exp, cfg, ckpt)
        k1.fused_upscale_noise_2d.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            eval_image.main(["--exp-dir", exp, "--num-samples", "10"])
        secs = time.perf_counter() - t0
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("SIFID: ")]
        check(len(lines) == 1, f"CLI printed {buf.getvalue()!r}")
        sifid = float(lines[0].split()[1])
        check(math.isfinite(sifid) and sifid >= 0, f"SIFID {sifid}")
        samples = np.load(os.path.join(exp, "eval", "random_samples.npy"))
        check(samples.shape == (10, 3, 257, 257), f"npy {samples.shape}")
        check(bool(np.isfinite(samples).all())
              and float(np.abs(samples).max()) <= 1.0, "bad samples")
        pngs = sorted(os.listdir(os.path.join(exp, "eval", "images")))
        check(pngs == [f"fake_{i}.png" for i in range(4)], f"PNGs {pngs}")
        with open(os.path.join(exp, "eval", "metrics.json")) as f:
            metrics = json.load(f)
        check(metrics["metric"] == "SIFID" and metrics["value"] == sifid,
              f"metrics.json {metrics}")
    print(f"  CLI: SIFID: {sifid} (random weights, random Inception "
          f"features), 10 samples, {secs:.2f} s, K1 launches "
          f"{k1.fused_upscale_noise_2d.launches} (per-sample BN runs none)",
          flush=True)
    return sifid


def tiny_config(**kw):
    from hpvaegan_tpu_torch.config import Config

    return Config(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1,
                  img_size=32, min_size=16, max_size=32, vae_levels=2,
                  **kw).finalize()


def phase_step_parity(torch, cfg, ndim=2, generator="GeneratorHPVAEGAN",
                      discriminator=""):
    """One VAE-scale G step and one GAN-scale iteration of a tiny 2D or 3D
    config (a baseline's: two GAN-scale iterations), card vs CPU."""
    from hpvaegan_tpu_torch.tools.step_parity import compare_devices

    out = {}
    for scale_idx in (1, 3):
        errs = compare_devices(cfg, scale_idx, seed=SEED, device="cuda",
                               ndim=ndim, generator=generator,
                               discriminator=discriminator)
        check(errs["finite"], f"scale {scale_idx}: non-finite values on "
              f"the card: {errs}")
        check(errs["metrics_rel"] <= 1e-4, f"scale {scale_idx}: metrics "
              f"differ by {errs['metrics_rel']} (rtol 1e-4)")
        for part in ("grads_abs", "state_abs"):
            check(errs[part] <= 1e-4, f"scale {scale_idx}: {part} "
                  f"{errs[part]} > 1e-4")
        out[scale_idx] = {k: v for k, v in errs.items()
                          if k not in ("finite", "metrics_host")}
        print(f"  scale {scale_idx} (card vs CPU, TF32 off): " + json.dumps(
            out[scale_idx]), flush=True)
    return out


def image_train_args(run, *extra, graph=False):
    """Phase 6's train_image flags (full width, 10 scales x 4 iterations),
    one eager iteration a chunk (--split-step, the per-iteration loop that
    phases 6-21 hold) unless `graph`."""
    return ["--image-path", os.path.join(HERE, "data", "imgs",
                                         "air_balloons.jpg"),
            "--niter", "4", "--print-interval", "2", "--run-dir", run,
            "--checkname", "smoke", "--manualSeed", "1",
            *(() if graph else ("--split-step",)), *extra]


def video_train_args(run, *extra):
    """Phase 11's train_video flags (full width, 10 scales x 2
    iterations), one eager iteration a chunk (--split-step)."""
    return ["--video-path", os.path.join(HERE, "data", "vids",
                                         "balloons_pan.avi"),
            "--max-frames", "13", "--sampling-rates", "4", "3", "2", "1",
            "--niter", "2", "--print-interval", "1", "--run-dir", run,
            "--checkname", "smoke", "--manualSeed", "1", "--split-step",
            *extra]


@contextlib.contextmanager
def exact_math(torch):
    """TF32 off and deterministic cuDNN, so that two runs of the same
    training take the same arithmetic."""
    flags = (torch.backends.cudnn, "allow_tf32", False), \
        (torch.backends.cuda.matmul, "allow_tf32", False), \
        (torch.backends.cudnn, "deterministic", True)
    saved = [getattr(mod, name) for mod, name, _ in flags]
    for mod, name, value in flags:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for (mod, name, _), value in zip(flags, saved):
            setattr(mod, name, value)


def phase_train_cli(torch, k1, run):
    """The training CLI at full width (TF32 off, deterministic cuDNN: phase
    13 resumes against it), then the eval CLI on its output. The experiment
    stays in `run`."""
    import numpy as np

    from hpvaegan_tpu_torch import eval_image, train_image

    k1.fused_upscale_noise_2d.launches = 0
    t0 = time.perf_counter()
    with exact_math(torch):
        exp = train_image.main(image_train_args(run))
    train_s = time.perf_counter() - t0
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == 0, f"training launched K1 {launches} times")
    files = set(os.listdir(exp))
    for k in range(10):
        check(f"netG_{k}.ckpt" in files, f"no netG_{k}.ckpt in {exp}")
        check((f"netD_{k}.ckpt" in files) == (k >= 3),
              f"netD_{k}.ckpt: {sorted(files)}")
    with open(os.path.join(exp, "intermediate.json")) as f:
        inter = json.load(f)
    amps = inter["noise_amps"]
    check(inter["scale_idx"] == 9 and len(amps) == 10 and amps[0] == 1.0
          and all(math.isfinite(a) and a > 0 for a in amps),
          f"intermediate.json {inter}")
    with open(os.path.join(exp, "logbook.txt")) as f:
        logged = [ln.split("] ", 1)[1] for ln in f.read().splitlines()
                  if "[Scale " in ln]
    check(len(logged) == 20, f"{len(logged)} logged loss lines, want 20")
    losses = [float(kv.split(": ")[1]) for ln in logged
              for kv in ln.split(", ")]
    check(all(math.isfinite(v) for v in losses), f"losses {logged}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_image.main(["--exp-dir", exp, "--num-samples", "10"])
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("SIFID: ")]
    check(len(lines) == 1, f"eval CLI printed {buf.getvalue()!r}")
    sifid = float(lines[0].split()[1])
    check(math.isfinite(sifid) and sifid >= 0, f"SIFID {sifid}")
    samples = np.load(os.path.join(exp, "eval", "random_samples.npy"))
    check(samples.shape == (10, 3, 192, 257), f"npy {samples.shape}")
    print(f"  trained {len(amps)} scales x 4 iterations in {train_s:.1f} s "
          f"(TF32 off, deterministic cuDNN), amps "
          f"{[round(a, 5) for a in amps]}, last losses {logged[-1]}; "
          f"K1 launches {launches}; eval CLI SIFID: {sifid}", flush=True)
    return {"train_s": train_s, "sifid": sifid, "amps": amps, "exp": exp}


def _group(name):
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "memcpy"
    if "multi_tensor_apply" in low or "adam" in low:
        return "optimizer"
    if any(k in low for k in ("conv", "cudnn", "gemm", "xmma", "sm90",
                              "sm80", "implicit", "wgrad", "dgrad")):
        return "conv"
    return "elementwise"


def device_summary(prof, wall_ms, what):
    """Device busy ms, idle share, device op count, ms by group and the top
    8 kernels of one profiler window of `wall_ms` host milliseconds."""
    from torch.autograd import DeviceType

    by_name, groups, n_kernels = {}, {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        n_kernels += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        groups[_group(e.name)] = groups.get(_group(e.name), 0.0) + ms
    busy = sum(by_name.values())
    check(busy > 0, f"{what}: the profile shows no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wall_ms": round(wall_ms, 3),
            "device_busy_ms": round(busy, 3),
            "idle_share": round(1 - busy / wall_ms, 4),
            "device_ops": n_kernels,
            "groups_ms": {k: round(v, 3) for k, v in sorted(groups.items())},
            "top_kernels_ms": [[k[:70], round(v, 3)] for k, v in top]}


def time_scale(torch, cfg, dataset, scale_idx, amps, ndim=2):
    """Steps/s, D and G ms and one profiled iteration at one scale of a 2D
    or 3D run: 3 warm-up and 10 timed iterations, cut to 2 and 3 when the
    second warm-up takes over 1 s (the 3D scale-9 runs). Until phase 22
    came, which measures the TF32-off scale-2 and scale-9 iterations
    again, these were 20 timed iterations and the cut came at 2 s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hpvaegan_tpu_torch.tools.step_parity import build_state
    from hpvaegan_tpu_torch.training.steps import (batch_former, d_step,
                                                   g_step, train_iteration)
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    vae = cfg.vae_levels >= scale_idx + 1
    st = build_state(cfg, scale_idx, SEED, "cuda", ndim)
    st.noise = NoiseSource(SEED, "cuda")
    if ndim == 2:
        data = dataset.scale_image(scale_idx), dataset.scale_image(0)
    else:
        data = dataset.scale_frames(scale_idx), dataset.scale_frames(0)
    former = batch_former(ndim, scale_idx)

    def iteration():
        return train_iteration(cfg, st, data[0], data[1], amps, vae, former)

    iteration()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iteration()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cut = warm_s > 1.0
    reps = 3 if cut else 10
    if not cut:
        iteration()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        metrics = iteration()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(float(v)) for v in metrics.values()),
          f"scale {scale_idx}: metrics {metrics}")

    d_ms = g_ms = 0.0
    for _ in range(reps):
        real, real_zero, noise_init = former(cfg, data[0], data[1], st.noise)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not vae:
            d_step(cfg, st, real, noise_init, amps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g_step(cfg, st, real, real_zero, noise_init, amps, vae)
        torch.cuda.synchronize()
        d_ms += (t1 - t0) * 1e3 / reps
        g_ms += (time.perf_counter() - t1) * 1e3 / reps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        iteration()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    summary = device_summary(prof, wall_ms, f"scale {scale_idx}")
    # the operators that launched them, by input shapes (self device time:
    # no double counting between an op and the ops it calls)
    averages = [e for e in prof.key_averages(group_by_input_shape=True)
                if e.device_type == DeviceType.CPU
                and e.self_device_time_total > 0]
    ops = sorted(((e.key, e.count, e.self_device_time_total / 1e3,
                   str(e.input_shapes)[:120]) for e in averages),
                 key=lambda r: -r[2])[:8]
    # the GP double backward's weight gradient of D's input-gradient: the
    # convolutions whose "weight" is a whole activation of the scale
    size = list(real.shape[2:])
    huge = [(str(e.input_shapes[:2]), e.count,
             round(e.self_device_time_total / 1e3, 3)) for e in averages
            if e.key == "aten::cudnn_convolution" and len(e.input_shapes) > 1
            and list(e.input_shapes[1][2:]) == size]
    return {
        "phase": "vae" if vae else "gan", "size": size,
        "timed_iterations": reps,
        "cut": f"second warm-up took {warm_s:.2f} s > 1 s: 2 warm-up, "
               f"{reps} timed iterations" if cut else None,
        "steps_per_s": round(1.0 / step_s, 3),
        "d_step_ms": round(d_ms, 3) if not vae else None,
        "g_step_ms": round(g_ms, 3), "peak_gb": round(peak_gb, 3),
        **summary,
        "top_ops_ms": [[k[:40], n, round(v, 3), shapes]
                       for k, n, v, shapes in ops],
        "gp_image_kernel_convs_ms": {
            "total": round(sum(ms for _, _, ms in huge), 3),
            "by_shape": [[s_, n, ms] for s_, n, ms in huge]}}


@contextlib.contextmanager
def cudnn_benchmark(torch):
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = False


def phase_step_timing(torch):
    """Train iterations at full width, batch 1: scale 9 (GAN) and 2 (VAE)
    as the trainer runs them (PyTorch's defaults: cuDNN TF32 on, cuDNN
    benchmark off), then scale 9 again with cudnn.benchmark on, and with
    TF32 off and deterministic cuDNN (phase 13's settings)."""
    from hpvaegan_tpu_torch.data.image import SingleImageDataset

    image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
    cfg = full_width_config(image_path=image, batch_size=1)
    dataset = SingleImageDataset(cfg, "cuda")
    amps = [1.0] + [0.05] * (cfg.stop_scale + 1)
    out = {}
    for name, scale_idx, mode in (
            ("scale 9", 9, contextlib.nullcontext()),
            ("scale 2", 2, contextlib.nullcontext()),
            ("scale 9, cudnn.benchmark", 9, cudnn_benchmark(torch)),
            ("scale 9, TF32 off, deterministic cuDNN", 9, exact_math(torch))):
        with mode:
            out[name] = time_scale(torch, cfg, dataset, scale_idx, amps)
        print(f"  {name}: " + json.dumps(out[name]), flush=True)
    return out


def video_config(**kw):
    """The full-width video model on balloons_pan.avi: Config() defaults,
    13 frames, sampling rates 4 3 2 1; the dataset sets org_fps, ar and
    fps_lcm from the clip. Returns (cfg, dataset on the card)."""
    from hpvaegan_tpu_torch.data.video import SingleVideoDataset
    from hpvaegan_tpu_torch.utils import pyramid

    video = os.path.join(HERE, "data", "vids", "balloons_pan.avi")
    check(os.path.isfile(video), f"missing {video}")
    cfg = full_width_config(video_path=video, max_frames=13,
                            sampling_rates=[4, 3, 2, 1], **kw)
    dataset = SingleVideoDataset(cfg, "cuda")
    cfg.fps, cfg.td, cfg.fps_index = pyramid.get_fps_td_by_index(
        cfg.scale_idx, cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps,
        cfg.fps_lcm)
    return cfg, dataset


def video_sizes(cfg):
    """[T, H, W] of every scale of the video pyramid."""
    from hpvaegan_tpu_torch.utils import pyramid

    return [pyramid.scale_size_3d(i, cfg.scale_factor, cfg.stop_scale,
                                  cfg.img_size, cfg.stop_scale_time,
                                  cfg.sampling_rates, cfg.org_fps,
                                  cfg.fps_lcm, cfg.ar)
            for i in range(cfg.stop_scale + 1)]


def conv_flops(module, fn):
    """FLOPs (2 per multiply-add) of the convolutions of `module` that one
    call of fn() runs, from each conv's output shape."""
    from hpvaegan_tpu_torch.models.blocks import Conv

    total = [0]

    def count(conv, _, y):
        total[0] += 2 * y.numel() * conv.weight[0].numel()

    hooks = [m.register_forward_hook(count) for m in module.modules()
             if isinstance(m, Conv)]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def phase_video_sampler(torch, k1, cfg, ckpt):
    """The video main path at full width, 64 samples, both BatchNorm modes;
    one profiled forward; cudnn.benchmark on; tiny config card vs CPU."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from hpvaegan_tpu_torch.data.video import SingleVideoDataset
    from hpvaegan_tpu_torch.evaluation import eval_z_tail, generate_samples
    from hpvaegan_tpu_torch.models.networks_3d import GeneratorHPVAEGAN
    from hpvaegan_tpu_torch.parallel import sampling
    from hpvaegan_tpu_torch.tools.step_parity import compare_sampler_devices

    gen = load_port_generator(cfg, ckpt, "cuda", ndim=3)
    shape = (BATCH,) + tuple(video_sizes(cfg)[-1]) + (3,)
    parts = sampling.sub_batches(BATCH, sampling._sample_elements(
        cfg, 3, cfg.stop_scale, eval_z_tail(cfg, 3)))
    out = {"sub_batches": [b - a for a, b in parts]}
    print(f"  z {(BATCH,) + eval_z_tail(cfg, 3)}, samples {shape}, "
          f"sub-batches {out['sub_batches']}", flush=True)

    def run(train, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = generate_samples(cfg, gen, ndim=3, train_mode=train,
                                   seed=seed)
        return samples, time.perf_counter() - t0

    # FLOPs of the convolutions of one 64-sample call, 2 per multiply-add,
    # counted from each conv's output shape during the first warm-up
    flops = conv_flops(gen, lambda: run(True, SEED))
    out["conv_tflop"] = round(flops / 1e12, 3)
    for name, train in (("per_sample_bn", True), ("moving", False)):
        run(train, SEED)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        k1.fused_upscale_noise_2d.launches = 0
        secs = []
        for r in range(2):
            samples, sec = run(train, SEED + 1 + r)
            secs.append(sec)
        launches = k1.fused_upscale_noise_2d.launches
        check(launches == 0, f"{name}: the video path launched K1 "
              f"{launches} times")
        check(samples.shape == shape, f"{name}: samples {samples.shape}, "
              f"want {shape}")
        check(bool(np.isfinite(samples).all()), f"{name}: non-finite samples")
        check(float(np.abs(samples).max()) <= 1.0,
              f"{name}: samples outside [-1, 1]")
        sec = sum(secs) / len(secs)
        out[name] = {"s": [round(t, 4) for t in secs],
                     "videos_per_s": round(BATCH / sec, 3),
                     "frames_per_s": round(BATCH * cfg.td / sec, 2),
                     "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9,
                                      3),
                     "std": round(float(samples.std()), 4),
                     "k1_launches": launches}
        print(f"  {name}: " + json.dumps(out[name]), flush=True)
        del samples

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        samples, sec = run(True, SEED)
    out["profile"] = device_summary(prof, sec * 1e3, "video forward")
    conv_ms = out["profile"]["groups_ms"].get("conv", 0.0)
    out["profile"].update({
        "conv_tflop": out["conv_tflop"],
        "conv_group_tflop_per_s": round(flops / conv_ms / 1e9, 2)
        if conv_ms else None,
        "conv_tf32_bound_ms": round(flops / H100_TF32_FLOPS * 1e3, 3),
        "d2h_mb": round(samples.nbytes / 1e6, 1)})
    del samples
    print("  profile of one per-sample-BN forward (host numpy out): "
          + json.dumps(out["profile"]), flush=True)

    torch.backends.cudnn.benchmark = True
    try:
        run(True, SEED)  # autotunes every conv shape
        _, sec = run(True, SEED + 1)
    finally:
        torch.backends.cudnn.benchmark = False
    out["cudnn_benchmark"] = {"s": round(sec, 4),
                              "videos_per_s": round(BATCH / sec, 3),
                              "frames_per_s": round(BATCH * cfg.td / sec, 2)}
    print("  per_sample_bn, cudnn.benchmark on: "
          + json.dumps(out["cudnn_benchmark"]), flush=True)

    # the same batch as one forward, without the sampler's split: what the
    # split saves in memory and costs in time
    cap = sampling.MAX_ELEMENTS
    sampling.MAX_ELEMENTS = 2 ** 62
    try:
        torch.cuda.reset_peak_memory_stats()
        _, sec = run(True, SEED)
    finally:
        sampling.MAX_ELEMENTS = cap
    out["one_forward"] = {"s": round(sec, 4), "peak_gb": round(
        torch.cuda.max_memory_allocated() / 1e9, 3)}
    print("  per_sample_bn as one forward of 64 (no split): "
          + json.dumps(out["one_forward"]), flush=True)
    del gen
    torch.cuda.empty_cache()

    tiny = tiny_config(video_path=os.path.join(HERE, "data", "vids",
                                               "synthetic.avi"),
                       max_frames=5, sampling_rates=[2, 1], niter=1,
                       num_samples=3)
    SingleVideoDataset(tiny, "cpu")
    tiny.scale_idx = tiny.stop_scale
    tiny.Noise_Amps = [1.0] + [0.3] * tiny.stop_scale
    small = GeneratorHPVAEGAN(tiny)
    g = torch.Generator().manual_seed(SEED)
    for _ in range(tiny.stop_scale):
        small.init_next_stage(g)
    out["card_vs_cpu"] = {}
    for name, train in (("per_sample_bn", True), ("moving", False)):
        diff = compare_sampler_devices(tiny, small, 3, train, SEED, "cuda")
        check(diff <= 1e-4, f"tiny 3D sampler ({name}): card and CPU differ "
              f"by {diff} (TF32 off)")
        out["card_vs_cpu"][name] = diff
    print("  tiny 3D sampler, card vs CPU, TF32 off, max |diff|: "
          + json.dumps(out["card_vs_cpu"]), flush=True)
    return out


def phase_video_cli(torch, k1, cfg, ckpt):
    """The user's eval_video CLI on a JAX-format video experiment dir."""
    from hpvaegan_tpu_torch import eval_video, evaluation
    from hpvaegan_tpu_torch.metrics import fid
    from hpvaegan_tpu_torch.utils import media

    # seconds in the three parts of the run that touch every sample, from
    # wrappers around the functions the CLI calls (the rest is setup: the
    # decode, the checkpoint, the real frames)
    parts = {}
    originals = [(m, n, getattr(m, n)) for m, n in (
        (evaluation, "generate_samples"), (media, "generate_gifs"),
        (fid, "svfid_arrays"))]

    def timed(name, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                parts[name] = round(time.perf_counter() - t0, 3)
        return wrapper

    for m, n, fn in originals:
        setattr(m, n, timed(n, fn))
    try:
        result = _run_video_cli(k1, cfg, ckpt, eval_video)
    finally:
        for m, n, fn in originals:
            setattr(m, n, fn)
    result["parts_s"] = parts
    print(f"  CLI: SVFID: {result['svfid']} (random weights, random C3D "
          f"features), 10 samples, {result['s']:.2f} s, of which "
          f"{json.dumps(parts)}; K1 launches 0", flush=True)
    return result


def _run_video_cli(k1, cfg, ckpt, eval_video):
    import numpy as np

    with tempfile.TemporaryDirectory(prefix="hpv_video_") as exp:
        write_experiment(exp, cfg, ckpt)
        k1.fused_upscale_noise_2d.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            eval_video.main(["--exp-dir", exp, "--num-samples", "10"])
        secs = time.perf_counter() - t0
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("SVFID: ")]
        check(len(lines) == 1, f"CLI printed {buf.getvalue()!r}")
        svfid = float(lines[0].split()[1])
        check(math.isfinite(svfid) and svfid >= 0, f"SVFID {svfid}")
        ev = os.path.join(exp, "eval")
        t, h, w = video_sizes(cfg)[-1]
        samples = np.load(os.path.join(ev, "random_samples.npy"))
        check(samples.shape == (10, 3, t, h, w), f"npy {samples.shape}")
        check(bool(np.isfinite(samples).all())
              and float(np.abs(samples).max()) <= 1.0, "bad samples")
        real = np.load(os.path.join(ev, "real_full_scale.npy"))
        check(real.shape == (cfg.max_frames, h, w, 3)
              and real.dtype == np.uint8,
              f"real_full_scale.npy {real.shape} {real.dtype}")
        files = sorted(os.listdir(os.path.join(ev, "images")))
        check(files == ["fake.gif", "fake_unfold.png", "real.gif",
                        "real_unfold.png"], f"artifacts {files}")
        with open(os.path.join(ev, "metrics.json")) as f:
            metrics = json.load(f)
        check(metrics["metric"] == "SVFID" and metrics["value"] == svfid,
              f"metrics.json {metrics}")
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == 0, f"the video CLI launched K1 {launches} times")
    return {"svfid": svfid, "s": secs}


def timed_scales(trainer, main, args):
    """main(args) with the seconds of each trainer.train_scale call (it
    returns after the checkpoints' copy to the host); returns (experiment
    dir, total seconds, seconds per scale)."""
    scale_s = []
    train_scale = trainer.train_scale

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return train_scale(*a, **kw)
        finally:
            scale_s.append(round(time.perf_counter() - t0, 2))

    trainer.train_scale = timed
    try:
        t0 = time.perf_counter()
        exp = main(args)
        return exp, time.perf_counter() - t0, scale_s
    finally:
        trainer.train_scale = train_scale


def phase_video_train_cli(torch, k1, run, *extra):
    """The video training CLI at full width (TF32 off, deterministic cuDNN:
    phase 13 resumes against it), with `extra` flags, then eval_video on
    its output. The experiment stays in `run`."""
    import numpy as np

    from hpvaegan_tpu_torch import eval_video, train_video
    from hpvaegan_tpu_torch.training import trainer

    k1.fused_upscale_noise_2d.launches = 0
    with exact_math(torch):
        exp, train_s, scale_s = timed_scales(trainer, train_video.main,
                                             video_train_args(run, *extra))
    check(len(scale_s) == 10, f"{len(scale_s)} scales timed")
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == 0, f"video training launched K1 {launches} times")
    check(exp == os.path.join(run, "balloons_pan", "smoke",
                              "experiment_0"), f"experiment dir {exp}")
    files = set(os.listdir(exp))
    for k in range(10):
        check(f"netG_{k}.ckpt" in files, f"no netG_{k}.ckpt in {exp}")
        check((f"netD_{k}.ckpt" in files) == (k >= 3),
              f"netD_{k}.ckpt: {sorted(files)}")
    with open(os.path.join(exp, "intermediate.json")) as f:
        inter = json.load(f)
    amps = inter["noise_amps"]
    check(inter["scale_idx"] == 9 and len(amps) == 10 and amps[0] == 1.0
          and all(math.isfinite(a) and a > 0 for a in amps),
          f"intermediate.json {inter}")
    with open(os.path.join(exp, "logbook.txt")) as f:
        logged = [ln.split("] ", 1)[1] for ln in f.read().splitlines()
                  if "[Scale " in ln]
    check(len(logged) == 20, f"{len(logged)} logged loss lines, want 20")
    losses = [float(kv.split(": ")[1]) for ln in logged
              for kv in ln.split(", ")]
    check(all(math.isfinite(v) for v in losses), f"losses {logged}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        eval_video.main(["--exp-dir", exp, "--num-samples", "10"])
    eval_s = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("SVFID: ")]
    check(len(lines) == 1, f"eval_video CLI printed {buf.getvalue()!r}")
    svfid = float(lines[0].split()[1])
    check(math.isfinite(svfid) and svfid >= 0, f"SVFID {svfid}")
    samples = np.load(os.path.join(exp, "eval", "random_samples.npy"))
    check(samples.shape == (10, 3, 13, 192, 257), f"npy {samples.shape}")
    check(bool(np.isfinite(samples).all()), "non-finite samples")
    print(f"  {' '.join(('train_video',) + extra) + ': ' if extra else ''}"
          f"trained 10 scales x 2 iterations in {train_s:.1f} s (TF32 off, "
          f"deterministic cuDNN; seconds per scale {scale_s}), amps "
          f"{[round(a, 5) for a in amps]}, last losses {logged[-1]}; K1 "
          f"launches {launches}; eval_video CLI SVFID: {svfid} "
          f"({eval_s:.2f} s)", flush=True)
    return {"train_s": train_s, "scale_s": scale_s, "amps": amps,
            "svfid": svfid, "eval_s": eval_s, "exp": exp}


class Killed(Exception):
    """Raised by phase 13's step_callback to stop a training run."""


def killed_run(trainer, main, args, scale_idx, at_iter):
    """main(args) stopped through step_callback after iteration `at_iter`
    of scale `scale_idx` (G's stage count tells the scale); returns the
    experiment dir."""
    run_training, made = trainer.run_training, []

    def callback(done, st, metrics):
        if len(st.G.body) - st.G.body_offset == scale_idx \
                and done == at_iter:
            raise Killed

    def stopped(cfg, saver, *a, **kw):
        made.append(saver.experiment_dir)
        return run_training(cfg, saver, *a, step_callback=callback, **kw)

    trainer.run_training = stopped
    try:
        main(args)
        fail(f"the run went past scale {scale_idx} iteration {at_iter}")
    except Killed:
        pass
    finally:
        trainer.run_training = run_training
    return made[0]


def max_tree_diff(a, b):
    """The largest absolute difference of two checkpoint pytrees."""
    import numpy as np

    if isinstance(a, dict):
        check(sorted(a) == sorted(b), f"keys {sorted(a)} vs {sorted(b)}")
        return max(max_tree_diff(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        check(len(a) == len(b), "list lengths differ")
        return max(max_tree_diff(x, y) for x, y in zip(a, b))
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def resume_and_compare(torch, main, ref, args, killed, netg):
    """Resume `killed` from its `netg` and hold netG_9 and the amps against
    the uninterrupted `ref`; returns (max |diff|, resumed seconds)."""
    t0 = time.perf_counter()
    with exact_math(torch):
        exp = main(args + ["--netG", os.path.join(killed, netg),
                           "--intermediate",
                           os.path.join(killed, "intermediate.json")])
    secs = time.perf_counter() - t0
    with open(os.path.join(exp, "intermediate.json")) as f:
        inter = json.load(f)
    with open(os.path.join(ref, "intermediate.json")) as f:
        want = json.load(f)
    check("inflight" not in inter and "key" not in inter,
          f"final intermediate.json {inter}")
    check(inter["scale_idx"] == 9 and inter["noise_amps"] == want["noise_amps"],
          f"resumed amps {inter['noise_amps']} vs {want['noise_amps']}")
    check(not [f for f in os.listdir(exp) if f.startswith("inflight_")],
          f"inflight checkpoints left in {exp}")
    with open(os.path.join(exp, "netG_9.ckpt"), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(ref, "netG_9.ckpt"), "rb") as f:
        diff = max_tree_diff(got, pickle.load(f))
    check(diff <= 1e-4, f"resumed netG_9 differs by {diff}")
    return diff, secs


def phase_resume(torch, k1, run, image_exp, video_exp):
    """Kill-and-resume of phase 6's and phase 11's runs (module doc)."""
    from hpvaegan_tpu_torch import train_image, train_video
    from hpvaegan_tpu_torch.training import trainer
    from hpvaegan_tpu_torch.utils.saver import DataSaver

    writes = []
    save_inflight = DataSaver.save_inflight

    def timed_save(self, scale_idx, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_inflight(self, scale_idx, *a, **kw)
        writes.append((scale_idx, time.perf_counter() - t0))

    out = {}
    DataSaver.save_inflight = timed_save
    k1.fused_upscale_noise_2d.launches = 0
    try:
        for name, main, make_args, ref, niter, interval, at in (
                ("image", train_image.main, image_train_args, image_exp, 4,
                 2, 2),
                ("video", train_video.main, video_train_args, video_exp, 2,
                 1, 1)):
            writes.clear()
            args = make_args(os.path.join(run, f"{name}_kill"),
                             "--ckpt-interval", str(interval))
            t0 = time.perf_counter()
            with exact_math(torch):
                killed = killed_run(trainer, main, args, 9, at)
            kill_s = time.perf_counter() - t0
            with open(os.path.join(killed, "intermediate.json")) as f:
                inter = json.load(f)
            check(inter.get("inflight") == "inflight_9.ckpt"
                  and inter["inflight_iter"] == at and "key" not in inter,
                  f"{name}: killed marker {inter}")
            mb = os.path.getsize(os.path.join(killed, "inflight_9.ckpt")) / 1e6
            resumed_args = make_args(os.path.join(run, f"{name}_resumed"),
                                     "--ckpt-interval", str(interval),
                                     "--manualSeed", "7")
            diff, tail_s = resume_and_compare(torch, main, ref, resumed_args,
                                              killed, "inflight_9.ckpt")
            out[name] = {"netG_9_max_abs_diff": diff, "bit_equal": diff == 0,
                         "killed_run_s": round(kill_s, 2),
                         "resumed_tail_s": round(tail_s, 2),
                         "inflight_9_mb": round(mb, 2),
                         "inflight_9_write_ms": round(1e3 * writes[-1][1], 1),
                         "inflight_writes": len(writes)}
            print(f"  {name}, killed at scale 9 iteration {at} of {niter}, "
                  "resumed from inflight_9.ckpt: " + json.dumps(out[name]),
                  flush=True)

        args = image_train_args(os.path.join(run, "image_kill5"),
                                "--ckpt-interval", "2")
        with exact_math(torch):
            killed = killed_run(trainer, train_image.main, args, 5, 1)
        with open(os.path.join(killed, "intermediate.json")) as f:
            inter = json.load(f)
        check(inter["scale_idx"] == 4 and inter.get("torch_rng")
              == "torch_rng_4.pt" and "inflight" not in inter
              and "key" not in inter, f"finalized marker {inter}")
        diff, tail_s = resume_and_compare(
            torch, train_image.main, image_exp,
            image_train_args(os.path.join(run, "image_resumed5"),
                             "--ckpt-interval", "2", "--manualSeed", "7"),
            killed, "netG_4.ckpt")
        out["image_finalized"] = {"netG_9_max_abs_diff": diff,
                                  "bit_equal": diff == 0,
                                  "resumed_s": round(tail_s, 2)}
        print("  image, killed at the start of scale 5, resumed from the "
              "finalized marker of scale 4 (torch_rng_4.pt): "
              + json.dumps(out["image_finalized"]), flush=True)
    finally:
        DataSaver.save_inflight = save_inflight
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == 0, f"the resumed runs launched K1 {launches} times")
    return out


def phase_vae_nb(torch, k1, moving_hpvaegan):
    """GeneratorVAE_nb 2D at full width (module doc)."""
    import numpy as np

    from hpvaegan_tpu_torch import eval_image, train_image
    from hpvaegan_tpu_torch.evaluation import generate_samples
    from hpvaegan_tpu_torch.training import trainer

    dev = torch.device("cuda")
    cfg = full_width_config(pallas_fused_sampling=True,
                            generator="GeneratorVAE_nb")
    gen = load_port_generator(cfg, random_jax_checkpoint(cfg, SEED + 3), dev)
    check(type(gen).__name__ == "GeneratorVAE_nb", f"built {type(gen)}")
    generate_samples(cfg, gen, train_mode=False, seed=SEED)  # warm-up
    k1.fused_upscale_noise_2d.launches = 0
    out = generate_samples(cfg, gen, train_mode=False, seed=SEED + 1)
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == cfg.stop_scale,
          f"K1 launched {launches} times in one VAE_nb forward, want "
          f"{cfg.stop_scale}")
    check(out.shape == (BATCH, 257, 257, 3) and bool(np.isfinite(out).all())
          and float(np.abs(out).max()) <= 1.0,
          f"VAE_nb samples {out.shape} in [{out.min()}, {out.max()}]")
    timings = {}
    for name, train in (("fused_moving", False), ("per_sample_bn", True)):
        generate_samples(cfg, gen, train_mode=train, seed=SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in range(3):
            generate_samples(cfg, gen, train_mode=train, seed=SEED + r)
        timings[name] = 3 * BATCH / (time.perf_counter() - t0)
    timings["GeneratorHPVAEGAN_fused_moving_phase3"] = moving_hpvaegan
    print(f"  main path: K1 launches in one 64-sample VAE_nb forward: "
          f"{launches}; samples/s " + json.dumps(timings), flush=True)

    with exact_math(torch):
        cfg.Noise_Amps = [1.0] + [0.0] * cfg.stop_scale
        fused = generate_samples(cfg, gen, train_mode=False, seed=SEED + 7)
        cfg.pallas_fused_sampling = False
        plain = generate_samples(cfg, gen, train_mode=False, seed=SEED + 7)
    diff = float(np.abs(fused - plain).max())
    check(diff <= 1e-4, f"VAE_nb kernel path and plain path differ by {diff}")
    print(f"  VAE_nb kernel path vs plain path at amps 0 (TF32 off): max "
          f"|diff| {diff:.3g}", flush=True)
    del gen, fused, plain, out
    torch.cuda.empty_cache()

    steps = phase_step_parity(torch, tiny_config(generator="GeneratorVAE_nb"),
                              generator="GeneratorVAE_nb")

    with tempfile.TemporaryDirectory(prefix="hpv_nb_") as run:
        k1.fused_upscale_noise_2d.launches = 0
        exp, train_s, scale_s = timed_scales(
            trainer, train_image.main,
            image_train_args(run, "--generator", "GeneratorVAE_nb",
                             "--niter", "2"))
        check(k1.fused_upscale_noise_2d.launches == 0,
              "VAE_nb training launched K1")
        check(len(scale_s) == 10 and os.path.isfile(
            os.path.join(exp, "netG_9.ckpt")), f"VAE_nb run {scale_s}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            eval_image.main(["--exp-dir", exp, "--num-samples", "10"])
        eval_s = time.perf_counter() - t0
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("SIFID: ")]
        check(len(lines) == 1, f"eval CLI printed {buf.getvalue()!r}")
        sifid = float(lines[0].split()[1])
        check(math.isfinite(sifid) and sifid >= 0, f"VAE_nb SIFID {sifid}")
    print(f"  train_image --generator GeneratorVAE_nb: 10 scales x 2 "
          f"iterations in {train_s:.1f} s (seconds per scale {scale_s}); "
          f"eval_image SIFID: {sifid} ({eval_s:.2f} s)", flush=True)
    return {"launches": launches, "samples_per_s": timings,
            "kernel_vs_plain": diff, "steps": steps, "train_s": train_s,
            "scale_s": scale_s, "sifid": sifid}


def phase_video_step_timing(torch):
    """Video train iterations at full width, batch 1: scale 9 (GAN,
    13x192x257) and scale 2 (VAE, 4x38x51), as the trainer runs them, then
    scale 9 with TF32 off and deterministic cuDNN (phase 13's settings)."""
    cfg, dataset = video_config(batch_size=1)
    amps = [1.0] + [0.05] * (cfg.stop_scale + 1)
    out = {}
    for name, scale_idx, mode in (
            ("scale 9", 9, contextlib.nullcontext()),
            ("scale 2", 2, contextlib.nullcontext()),
            ("scale 9, TF32 off, deterministic cuDNN", 9, exact_math(torch))):
        with mode:
            out[name] = time_scale(torch, cfg, dataset, scale_idx, amps,
                                   ndim=3)
        print(f"  video {name}: " + json.dumps(out[name]), flush=True)
    return out


def baseline_sampler(torch, k1, name):
    """Phase 15 (b): one generator's full-width 64-sample per-sample-BN
    sampling (module doc)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from hpvaegan_tpu_torch.evaluation import eval_z_tail, generate_samples
    from hpvaegan_tpu_torch.parallel import sampling

    cfg, _ = video_config(generator=name,
                          discriminator="WDiscriminatorBaselines")
    gen = load_port_generator(cfg, random_jax_checkpoint(cfg, SEED + 5, 3),
                              "cuda", ndim=3)
    check(type(gen).__name__ == name and len(gen.body) == 10,
          f"built {type(gen).__name__} with {len(gen.body)} stages")
    z_tail = eval_z_tail(cfg, 3)
    per = sampling.generator_elements(cfg, gen, 3, z_tail)
    parts = [b - a for a, b in sampling.sub_batches(BATCH, per)]
    check(parts == [21, 21, 22] and max(parts) * per < 2 ** 31,
          f"{name}: sub-batches {parts} of {per} elements per sample")
    shape = (BATCH,) + tuple(video_sizes(cfg)[-1]) + (3,)

    def run(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = generate_samples(cfg, gen, ndim=3, train_mode=True,
                                   seed=seed)
        return samples, time.perf_counter() - t0

    flops = conv_flops(gen, lambda: run(SEED))  # the warm-up call
    torch.cuda.reset_peak_memory_stats()
    k1.fused_upscale_noise_2d.launches = 0
    secs = []
    for r in range(2):
        samples, sec = run(SEED + 1 + r)
        secs.append(sec)
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == 0, f"{name} sampling launched K1 {launches} times")
    check(samples.shape == shape, f"{name}: samples {samples.shape}, want "
          f"{shape}")
    check(bool(np.isfinite(samples).all())
          and float(np.abs(samples).max()) <= 1.0,
          f"{name}: samples outside [-1, 1] or not finite")
    sec = sum(secs) / len(secs)
    out = {"z": (BATCH,) + z_tail, "sub_batches": parts,
           "elements_per_sample": per, "s": [round(t, 4) for t in secs],
           "videos_per_s": round(BATCH / sec, 3),
           "frames_per_s": round(BATCH * shape[1] / sec, 2),
           "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
           "conv_tflop": round(flops / 1e12, 3),
           "std": round(float(samples.std()), 4), "k1_launches": launches}
    del samples
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        samples, sec = run(SEED)
    out["profile"] = device_summary(prof, sec * 1e3, f"{name} forward")
    conv_ms = out["profile"]["groups_ms"].get("conv", 0.0)
    out["profile"]["conv_group_tflop_per_s"] = round(
        flops / conv_ms / 1e9, 2) if conv_ms else None
    del samples, gen
    torch.cuda.empty_cache()
    print(f"  {name} sampler: " + json.dumps(out), flush=True)
    return out


def baseline_step_ms(torch, dataset, cfg, timed, reps):
    """D-step and G-step ms of each of `reps` synchronised iterations of
    GeneratorCSG at scale 9 (full width, batch 1) after one warm-up
    iteration, and the peak GB."""
    from hpvaegan_tpu_torch.tools.step_parity import build_state
    from hpvaegan_tpu_torch.training.steps import batch_former, d_step, g_step
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    amps = [1.0] + [0.05] * (cfg.stop_scale + 1)
    st = build_state(cfg, 9, SEED, "cuda", 3, "GeneratorCSG",
                     "WDiscriminatorBaselines")
    st.noise = NoiseSource(SEED, "cuda")
    former = batch_former(3, 9, baseline=True)
    data = dataset.scale_frames(9), dataset.scale_frames(0)
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + reps):
        real, real_zero, noise_init = former(cfg, data[0], data[1], st.noise)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_step(cfg, st, real, noise_init, amps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = g_step(cfg, st, real, real_zero, noise_init, amps, False)
        torch.cuda.synchronize()
        if i:
            timed.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    check(all(math.isfinite(float(v)) for v in metrics.values()),
          f"baseline scale 9 metrics {metrics}")
    return torch.cuda.max_memory_allocated() / 1e9


def phase_baselines(torch, k1, run):
    """Phase 15 (module doc)."""
    import numpy as np

    from hpvaegan_tpu_torch import eval_video, train_video_baselines
    from hpvaegan_tpu_torch.data.video import SingleVideoDataset
    from hpvaegan_tpu_torch.training import baselines_trainer, steps

    out = {"step": {}}
    tiny = tiny_config(video_path=os.path.join(HERE, "data", "vids",
                                               "synthetic.avi"),
                       max_frames=5, sampling_rates=[2, 1], hflip=True,
                       batch_size=2)
    SingleVideoDataset(tiny, "cpu")  # sets org_fps, ar, fps_lcm
    for name in ("GeneratorCSG", "GeneratorSG"):
        print(f"  (a) {name}, one tiny iteration at scales 1 and 3",
              flush=True)
        out["step"][name] = phase_step_parity(
            torch, tiny, ndim=3, generator=name,
            discriminator="WDiscriminatorBaselines")
    for name in ("GeneratorCSG", "GeneratorSG"):
        out[name] = baseline_sampler(torch, k1, name)

    # (c): the CLI, with the D and G steps of scale 9 timed in place
    scale = {}
    d_step, g_step = steps.d_step, steps.g_step

    def sync_timed(fn, slot):
        def wrapper(cfg, *a, **kw):
            if cfg.scale_idx != 9:
                return fn(cfg, *a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(cfg, *a, **kw)
            finally:
                torch.cuda.synchronize()
                scale.setdefault(slot, []).append(
                    round((time.perf_counter() - t0) * 1e3, 1))
        return wrapper

    steps.d_step = sync_timed(d_step, "d_ms")
    steps.g_step = sync_timed(g_step, "g_ms")
    args = video_train_args(run)
    k1.fused_upscale_noise_2d.launches = 0
    try:
        with exact_math(torch):
            exp, train_s, scale_s = timed_scales(
                baselines_trainer, train_video_baselines.main, args)
    finally:
        steps.d_step, steps.g_step = d_step, g_step
    check(k1.fused_upscale_noise_2d.launches == 0,
          "baselines training launched K1")
    files = set(os.listdir(exp))
    for k in range(10):
        check({f"netG_{k}.ckpt", f"netD_{k}.ckpt"} <= files,
              f"scale {k}: {sorted(files)}")
    check({"Z_init.npy", "intermediate.json"} <= files, f"{sorted(files)}")
    z = np.load(os.path.join(exp, "Z_init.npy"))
    check(z.shape == (1, 4, 24, 33, 3), f"Z_init {z.shape}")
    with open(os.path.join(exp, "intermediate.json")) as f:
        inter = json.load(f)
    amps = inter["noise_amps"]
    check(inter["scale_idx"] == 9 and len(amps) == 10 and amps[0] == 1.0
          and all(math.isfinite(a) and a > 0 for a in amps),
          f"intermediate.json {inter}")
    with open(os.path.join(exp, "logbook.txt")) as f:
        logged = [ln.split("] ", 1)[1] for ln in f.read().splitlines()
                  if "[Scale " in ln]
    check(len(logged) == 20 and all("d_loss" in ln for ln in logged),
          f"{len(logged)} logged loss lines, want 20 with d_loss")
    losses = [float(kv.split(": ")[1]) for ln in logged
              for kv in ln.split(", ")]
    check(all(math.isfinite(v) for v in losses), f"losses {logged}")
    check(len(scale.get("d_ms", [])) == 2 and len(scale.get("g_ms", [])) == 2,
          f"scale 9 steps timed: {scale}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        eval_video.main(["--exp-dir", exp, "--num-samples", "10"])
    eval_s = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("SVFID: ")]
    check(len(lines) == 1, f"eval_video printed {buf.getvalue()!r}")
    svfid = float(lines[0].split()[1])
    check(math.isfinite(svfid) and svfid >= 0, f"SVFID {svfid}")
    gifs = set(os.listdir(os.path.join(exp, "eval", "images")))
    check({"fake.gif", "real.gif"} <= gifs, f"eval artifacts {gifs}")
    out["cli"] = {"train_s": round(train_s, 2), "scale_s": scale_s,
                  "scale_9_tf32_off_deterministic": scale,
                  "amps": [round(a, 5) for a in amps], "svfid": svfid,
                  "eval_s": round(eval_s, 2), "last_losses": logged[-1]}
    print("  (c) train_video_baselines, GeneratorCSG, 10 scales x 2 "
          "iterations (TF32 off, deterministic cuDNN), then eval_video: "
          + json.dumps(out["cli"]), flush=True)

    cfg, dataset = video_config(generator="GeneratorCSG",
                                discriminator="WDiscriminatorBaselines",
                                batch_size=1)
    timed = []
    peak = baseline_step_ms(torch, dataset, cfg, timed, 2)
    out["scale_9_defaults"] = {
        "d_ms": [round(d, 1) for d, _ in timed],
        "g_ms": [round(g, 1) for _, g in timed], "peak_gb": round(peak, 3)}
    print("  scale 9 of GeneratorCSG with PyTorch's defaults (TF32 on), "
          "batch 1: " + json.dumps(out["scale_9_defaults"]), flush=True)
    del dataset
    torch.cuda.empty_cache()

    # (d)
    t0 = time.perf_counter()
    with exact_math(torch):
        killed = killed_run(baselines_trainer, train_video_baselines.main,
                            video_train_args(os.path.join(run, "b_kill"),
                                             "--ckpt-interval", "1"), 9, 1)
    kill_s = time.perf_counter() - t0
    with open(os.path.join(killed, "intermediate.json")) as f:
        inter = json.load(f)
    check(inter.get("inflight") == "inflight_9.ckpt"
          and inter["inflight_iter"] == 1, f"killed marker {inter}")
    diff, tail_s = resume_and_compare(
        torch, train_video_baselines.main, exp,
        video_train_args(os.path.join(run, "b_resumed"), "--ckpt-interval",
                         "1", "--manualSeed", "7"), killed, "inflight_9.ckpt")
    check(np.array_equal(np.load(os.path.join(run, "b_resumed", "balloons_pan",
                                              "smoke", "experiment_0",
                                              "Z_init.npy")), z),
          "the resumed run's Z_init differs")
    out["resume"] = {"netG_9_max_abs_diff": diff, "bit_equal": diff == 0,
                     "killed_run_s": round(kill_s, 2),
                     "resumed_tail_s": round(tail_s, 2)}
    print("  (d) killed at scale 9 iteration 1, resumed from "
          "inflight_9.ckpt: " + json.dumps(out["resume"]), flush=True)
    return out


# the training flags of phase 16 (a): (name, ndim, generator, Config flags)
FLAG_CASES = (
    ("--fused-dg 2D", 2, "GeneratorHPVAEGAN", dict(fused_dg=True)),
    ("--fused-dg 3D", 3, "GeneratorHPVAEGAN", dict(fused_dg=True)),
    ("--fused-dg CSG", 3, "GeneratorCSG", dict(fused_dg=True)),
    ("--paired-g 2D", 2, "GeneratorHPVAEGAN", dict(paired_g=True)),
    ("--flat-opt 2D", 2, "GeneratorHPVAEGAN", dict(flat_opt=True)),
    ("bf16 2D", 2, "GeneratorHPVAEGAN", dict(compute_dtype="bfloat16")),
    ("bf16 3D", 3, "GeneratorHPVAEGAN", dict(compute_dtype="bfloat16")))
# card (cuDNN bf16) against CPU (oneDNN bf16): one-ulp rounding differences
# of the two convolutions, spread by the bf16 chain; measured 2.1e-5, 3.9e-3
# and 9.5e-6 on an H100 (tests/test_torch_cuda.py)
BF16_CARD_TOL = {"metrics_scaled": 1e-3, "grads_abs": 2e-2,
                 "state_abs": 1e-4}
F32_CARD_TOL = {"metrics_rel": 1e-4, "grads_abs": 1e-4, "state_abs": 1e-4}
# phase 16 (b): the variants timed at scale 9, 2D and (first four) 3D
FLAG_VARIANTS = (("f32", {}), ("bf16", dict(compute_dtype="bfloat16")),
                 ("fused-dg", dict(fused_dg=True)),
                 ("bf16+fused-dg", dict(compute_dtype="bfloat16",
                                        fused_dg=True)),
                 ("paired-g", dict(paired_g=True)),
                 ("flat-opt", dict(flat_opt=True)))


def flags_parity(torch):
    """Phase 16 (a): one tiny GAN-scale iteration per flag, card (TF32 off,
    deterministic cuDNN) against CPU."""
    from hpvaegan_tpu_torch.data.video import SingleVideoDataset
    from hpvaegan_tpu_torch.tools.step_parity import compare_devices

    out = {}
    for name, ndim, generator, flags in FLAG_CASES:
        kw = dict(flags, generator=generator)
        if ndim == 3:
            kw.update(video_path=os.path.join(HERE, "data", "vids",
                                              "synthetic.avi"),
                      max_frames=5, sampling_rates=[2, 1], hflip=True,
                      batch_size=2)
        disc = ""
        if generator == "GeneratorCSG":
            disc = kw["discriminator"] = "WDiscriminatorBaselines"
        cfg = tiny_config(**kw)
        if ndim == 3:
            SingleVideoDataset(cfg, "cpu")  # sets org_fps, ar, fps_lcm
        with exact_math(torch):
            errs = compare_devices(cfg, 3, seed=SEED, device="cuda",
                                   ndim=ndim, generator=generator,
                                   discriminator=disc)
        tol = BF16_CARD_TOL if "compute_dtype" in flags else F32_CARD_TOL
        check(errs["finite"], f"{name}: non-finite values on the card")
        for k, bound in tol.items():
            check(errs[k] <= bound, f"{name}: {k} {errs[k]} > {bound}")
        out[name] = {k: v for k, v in errs.items()
                     if k not in ("finite", "metrics", "metrics_host")}
        if "compute_dtype" in flags:
            out[name]["metrics_card_host"] = {
                k: [round(v, 6), round(errs["metrics_host"][k], 6)]
                for k, v in errs["metrics"].items()}
        print(f"  (a) {name}, scale 3 (card vs CPU, TF32 off; bound "
              f"{tol}): " + json.dumps(out[name]), flush=True)
    return out


def gp_image_convs(prof, size, ker):
    """The GP double backward's convolutions whose weight is a whole
    activation of `size` (PERF.md §5), by input shapes: calls, device ms,
    kernel names, TFLOP/s (2 * N * Cout * ker^d * Cin * prod(size) per
    call: their output is the kernel's size)."""
    rows = {}
    for e in prof.events():
        if e.name != "aten::cudnn_convolution" or len(e.input_shapes) < 2 \
                or list(e.input_shapes[1][2:]) != size:
            continue
        (n, cin), cout = e.input_shapes[0][:2], e.input_shapes[1][0]
        row = rows.setdefault(str(e.input_shapes[:2]), {
            "calls": 0, "device_ms": 0.0, "flop": 0, "kernels": set()})
        row["calls"] += 1
        row["device_ms"] += e.device_time_total / 1e3
        row["flop"] += 2 * n * cout * ker ** len(size) * cin * math.prod(size)
        row["kernels"].update(k.name[:60] for k in getattr(e, "kernels", []))
    return {shape: {"calls": r["calls"], "device_ms": round(r["device_ms"], 3),
                    "tflop_per_s": round(r["flop"] / r["device_ms"] / 1e9, 3)
                    if r["device_ms"] else None,
                    "kernels": sorted(r["kernels"])}
            for shape, r in rows.items()}


def time_flag_variant(torch, cfg, dataset, ndim, warm, reps, split_reps,
                      profiled=False):
    """Scale 9 of a full-width 2D or 3D run, batch 1, with the flags in cfg
    (PyTorch's defaults otherwise): steps/s over `reps` iterations after
    `warm`, the D and G step ms (or the fused iteration's) synchronised,
    peak GB; with `profiled`, one profiled iteration's GP image-sized
    convolutions."""
    from torch.profiler import ProfilerActivity, profile

    from hpvaegan_tpu_torch.tools.step_parity import build_state
    from hpvaegan_tpu_torch.training.steps import (batch_former, d_step,
                                                   fused_dg_iteration,
                                                   g_step, train_iteration)
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    st = build_state(cfg, 9, SEED, "cuda", ndim)
    st.noise = NoiseSource(SEED, "cuda")
    if ndim == 2:
        data = dataset.scale_image(9), dataset.scale_image(0)
    else:
        data = dataset.scale_frames(9), dataset.scale_frames(0)
    former = batch_former(ndim, 9)
    amps = [1.0] + [0.05] * (cfg.stop_scale + 1)

    def iteration():
        return train_iteration(cfg, st, data[0], data[1], amps, False, former)

    for _ in range(warm):
        iteration()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        metrics = iteration()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    check(all(math.isfinite(float(v)) for v in metrics.values()),
          f"scale 9 metrics {metrics}")
    split = {}
    for _ in range(split_reps):
        real, real_zero, noise_init = former(cfg, data[0], data[1], st.noise)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cfg.fused_dg:
            fused_dg_iteration(cfg, st, real, real_zero, noise_init, amps)
        else:
            d_step(cfg, st, real, noise_init, amps)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            split["d_ms"] = split.get("d_ms", 0.0) + (t1 - t0) * 1e3
            t0 = t1
            g_step(cfg, st, real, real_zero, noise_init, amps, False)
        torch.cuda.synchronize()
        slot = "fused_iteration_ms" if cfg.fused_dg else "g_ms"
        split[slot] = split.get(slot, 0.0) + (time.perf_counter() - t0) * 1e3
    out = {"steps_per_s": round(1.0 / step_s, 3),
           **{k: round(v / split_reps, 1) for k, v in split.items()},
           "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
           "iterations": [warm, reps, split_reps]}
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            iteration()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        summary = device_summary(prof, wall_ms, "flags profile")
        convs = gp_image_convs(prof, list(real.shape[2:]), cfg.ker_size)
        out["profile"] = {k: summary[k] for k in (
            "profiled_wall_ms", "device_busy_ms", "idle_share",
            "groups_ms")}
        out["profile"]["gp_image_convs"] = convs
        out["profile"]["gp_image_convs_ms"] = round(sum(
            r["device_ms"] for r in convs.values()), 3)
    del st
    torch.cuda.empty_cache()
    return out


def flags_timing(torch):
    """Phase 16 (b): scale 9 at full width, batch 1, 2D (192x257) and 3D
    (13x192x257), each FLAG_VARIANTS entry in one call (3D: the first four,
    iteration counts cut as phase 12 cuts them; 2D 5 timed iterations
    after 3 warm-up ones, 3D 1 after 1, cut from 10 and 2 to keep the
    script in its time limit with phase 22); the bf16 variant
    profiled. 2D is host-bound here, and its rates move between calls;
    phase 22 measures the host-bound 2D iteration as CUDA-graph replays
    (until then each 2D variant also ran a second time, in reverse
    order)."""
    from hpvaegan_tpu_torch.data.image import SingleImageDataset

    out = {}
    image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
    for ndim in (2, 3):
        if ndim == 2:
            base = full_width_config(image_path=image, batch_size=1)
            dataset = SingleImageDataset(base, "cuda")
            variants, counts = FLAG_VARIANTS, (3, 5, 3)
        else:
            base, dataset = video_config(batch_size=1)
            variants, counts = FLAG_VARIANTS[:4], (1, 1, 1)
        for name, flags in variants:
            cfg = dataclasses.replace(base, **flags)
            key = f"{ndim}D {name}"
            res = out[key] = time_flag_variant(torch, cfg, dataset, ndim,
                                               *counts,
                                               profiled=name == "bf16")
            print(f"  (b) scale 9 {key} (PyTorch's defaults): "
                  + json.dumps(res), flush=True)
        del dataset
        torch.cuda.empty_cache()
    return out


def flags_main_path(torch, k1, run):
    """Phase 16 (c): train_video --compute-dtype bfloat16 --fused-dg at full
    width (10 scales x 2 iterations) then eval_video; train_image --paired-g
    --flat-opt --visualize --image-interval 2 --profile-dir (10 x 4)."""
    import numpy as np

    from hpvaegan_tpu_torch import eval_video, train_image, train_video
    from hpvaegan_tpu_torch.models import networks_2d
    from hpvaegan_tpu_torch.models.blocks import Conv
    from hpvaegan_tpu_torch.training import steps, trainer

    out = {}
    fused, dtypes = [], set()
    orig = steps.fused_dg_iteration

    def spy(cfg, st, *a):
        fused.append(cfg.scale_idx)
        dtypes.update(m.compute_dtype for m in st.G.modules()
                      if isinstance(m, Conv))
        return orig(cfg, st, *a)

    steps.fused_dg_iteration = spy
    k1.fused_upscale_noise_2d.launches = 0
    try:
        exp, train_s, scale_s = timed_scales(
            trainer, train_video.main,
            video_train_args(os.path.join(run, "bf16"), "--compute-dtype",
                             "bfloat16", "--fused-dg"))
    finally:
        steps.fused_dg_iteration = orig
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == 0, f"the bf16 fused video run launched K1 {launches} "
          "times")
    check(fused == [k for k in range(3, 10) for _ in range(2)],
          f"fused iterations at scales {fused}")
    check(dtypes == {torch.bfloat16}, f"G's convs ran in {dtypes}")
    with open(os.path.join(exp, "logbook.txt")) as f:
        logged = [ln.split("] ", 1)[1] for ln in f.read().splitlines()
                  if "[Scale " in ln]
    losses = [float(kv.split(": ")[1]) for ln in logged
              for kv in ln.split(", ")]
    check(len(logged) == 20 and all(math.isfinite(v) for v in losses),
          f"losses {logged}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        eval_video.main(["--exp-dir", exp, "--num-samples", "10"])
    eval_s = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("SVFID: ")]
    check(len(lines) == 1, f"eval_video printed {buf.getvalue()!r}")
    svfid = float(lines[0].split()[1])
    check(math.isfinite(svfid) and svfid >= 0, f"SVFID {svfid}")
    samples = np.load(os.path.join(exp, "eval", "random_samples.npy"))
    check(samples.dtype == np.float32 and samples.shape == (10, 3, 13, 192,
                                                            257),
          f"npy {samples.dtype} {samples.shape}")
    out["video"] = {"train_s": round(train_s, 2), "scale_s": scale_s,
                    "fused_iterations": len(fused), "k1_launches": launches,
                    "last_losses": logged[-1], "svfid": svfid,
                    "eval_s": round(eval_s, 2)}
    print("  (c) train_video --compute-dtype bfloat16 --fused-dg, 10 scales "
          "x 2, then eval_video: " + json.dumps(out["video"]), flush=True)

    paired = []
    pair = networks_2d.GeneratorHPVAEGAN.reconstruct_pair

    def counted(self, *a, **kw):
        paired.append(1)
        return pair(self, *a, **kw)

    prof_dir = os.path.join(run, "prof")
    networks_2d.GeneratorHPVAEGAN.reconstruct_pair = counted
    k1.fused_upscale_noise_2d.launches = 0
    t0 = time.perf_counter()
    try:
        exp = train_image.main(image_train_args(
            os.path.join(run, "flags"), "--paired-g", "--flat-opt",
            "--visualize", "--image-interval", "2", "--profile-dir",
            prof_dir))
    finally:
        networks_2d.GeneratorHPVAEGAN.reconstruct_pair = pair
    train_s = time.perf_counter() - t0
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == 0, f"the flagged image run launched K1 {launches} "
          "times")
    check(len(paired) == 7 * 4, f"{len(paired)} paired G steps, want 28")
    images = set(os.listdir(os.path.join(exp, "img")))
    want = {f"{p}_{i + 1}.jpg" for i in (2, 4)
            for p in ("real", "generated", "generated_vae")} | {
        f"fake_var_{i}.jpg" for i in (2, 4)} | {
        f"fake_vae_var{i}.jpg" for i in (2, 4)}
    check(images == want, f"img/ holds {sorted(images)}")
    check(os.listdir(prof_dir) == ["trace.json"],
          f"profile dir {os.listdir(prof_dir)}")
    path = os.path.join(prof_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    check(kernels > 0, "the trace holds no CUDA kernel events")
    out["image"] = {"train_s": round(train_s, 2), "paired_g_steps":
                    len(paired), "images": len(images),
                    "trace_mb": round(os.path.getsize(path) / 1e6, 1),
                    "trace_events": len(events), "kernel_events": kernels,
                    "k1_launches": launches}
    print("  (c) train_image --paired-g --flat-opt --visualize "
          "--image-interval 2 --profile-dir, 10 scales x 4: "
          + json.dumps(out["image"]), flush=True)
    return out


def phase_flags(torch, k1, run):
    """Phase 16 (module doc)."""
    return {"parity": flags_parity(torch), "timing": flags_timing(torch),
            "main": flags_main_path(torch, k1, run)}


def image_size(cfg):
    """(H, W) of the image pyramid's last scale."""
    from hpvaegan_tpu_torch.utils import pyramid

    return tuple(pyramid.scale_size_2d(cfg.stop_scale, cfg.scale_factor,
                                       cfg.stop_scale, cfg.img_size, cfg.ar))


def write_experiment(exp, cfg, ckpt):
    """A JAX-format experiment dir at cfg.stop_scale: args.txt,
    intermediate.json and netG_<k>.ckpt (the pickled pytree)."""
    cfg.write_args_txt(os.path.join(exp, "args.txt"))
    with open(os.path.join(exp, "intermediate.json"), "w") as f:
        json.dump({"noise_amps": cfg.Noise_Amps,
                   "scale_idx": cfg.stop_scale}, f)
    with open(os.path.join(exp, f"netG_{cfg.stop_scale}.ckpt"), "wb") as f:
        pickle.dump(ckpt, f)


def ondevice_eval(torch, k1, main, exp, metric, sample_shape):
    """`main` (eval_image or eval_video's) with --on-device-fid, 64
    samples, on `exp`, timed by wrappers around parallel/sampling.py's
    steps: the features and statistics (synchronised before and after),
    the copies to the host (bytes counted) and the Frechet distances; the
    rest of the run's time in `sampled_*fid` is sampling."""
    import numpy as np

    from hpvaegan_tpu_torch.parallel import sampling

    parts = {"features_stats_s": 0.0, "frechet_s": 0.0, "host_copy_s": 0.0,
             "host_bytes": 0, "host_copies": 0}
    run_name = "sampled_sifid" if metric == "SIFID" else "sampled_svfid"
    originals = {n: getattr(sampling, n) for n in (
        "_feature_stats", "_host_copy", "_frechet", run_name)}

    def feature_stats(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = originals["_feature_stats"](*args)
        torch.cuda.synchronize()
        parts["features_stats_s"] += time.perf_counter() - t0
        return out

    def host_copy(t):
        t0 = time.perf_counter()
        out = originals["_host_copy"](t)
        parts["host_copy_s"] += time.perf_counter() - t0
        parts["host_bytes"] += out.nbytes
        parts["host_copies"] += 1
        return out

    def frechet(*args):
        t0 = time.perf_counter()
        out = originals["_frechet"](*args)
        parts["frechet_s"] += time.perf_counter() - t0
        return out

    def run(*args, **kw):
        t0 = time.perf_counter()
        out = originals[run_name](*args, **kw)
        parts["sampled_fid_s"] = time.perf_counter() - t0
        return out

    for name, fn in (("_feature_stats", feature_stats),
                     ("_host_copy", host_copy), ("_frechet", frechet),
                     (run_name, run)):
        setattr(sampling, name, fn)
    k1.fused_upscale_noise_2d.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            main(["--exp-dir", exp, "--num-samples", str(BATCH),
                  "--on-device-fid"])
    finally:
        for name, fn in originals.items():
            setattr(sampling, name, fn)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith(f"{metric}: ")]
    check(len(lines) == 1, f"CLI printed {buf.getvalue()!r}")
    value = float(lines[0].split()[1])
    check(math.isfinite(value) and value >= 0, f"{metric} {value}")
    with open(os.path.join(exp, "eval", "metrics.json")) as f:
        rec = json.load(f)
    check(rec["metric"] == metric and rec["value"] == value
          and rec["on_device_fid"] is True and rec["num_samples"] == BATCH,
          f"metrics.json {rec}")
    samples = np.load(os.path.join(exp, "eval", "random_samples.npy"))
    check(samples.shape == (4,) + sample_shape
          and bool(np.isfinite(samples).all()),
          f"random_samples.npy {samples.shape}")
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == 0, f"on-device eval launched K1 {launches} times")
    check(parts["host_copies"] == 3, f"{parts['host_copies']} host copies "
          "(want the real side's stats, the fakes' stats, the 4 samples)")
    parts = {k: round(v, 4) if isinstance(v, float) else v
             for k, v in parts.items()}
    parts["sampling_s"] = round(parts["sampled_fid_s"]
                                - parts["features_stats_s"]
                                - parts["frechet_s"] - parts["host_copy_s"],
                                4)
    # the same CLI on the host path: all samples to the host, then the
    # files (SIFID: the max_samples PNGs) or the arrays (SVFID) scored
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(["--exp-dir", exp, "--num-samples", str(BATCH)])
    host_s = time.perf_counter() - t0
    host_value = float([ln for ln in buf.getvalue().splitlines()
                        if ln.startswith(f"{metric}: ")][0].split()[1])
    check(math.isfinite(host_value), f"host path {metric} {host_value}")
    if metric == "SVFID":
        # the same draws give the same 64 clips and the same real window
        # on both paths; only the statistics' precision differs
        check(abs(value - host_value) <= 1e-3 * abs(host_value),
              f"on-device SVFID {value} vs host path {host_value}")
    host_path_bytes = BATCH * int(np.prod(sample_shape)) * 4
    out = {"metric": metric, "value": value, "cli_s": round(secs, 3),
           **parts, "peak_gb": round(peak, 2),
           "host_path_sample_bytes": host_path_bytes,
           "host_path_cli_s": round(host_s, 3),
           "host_path_value": host_value, "k1_launches": 0}
    print(f"  (a) {metric} --on-device-fid, {BATCH} samples: "
          + json.dumps(out), flush=True)
    return out


def stats_card_vs_cpu(torch):
    """_per_sample_stats on the card (TF32 off) against the CPU on the same
    tiny C3D-like features; largest differences relative to the largest
    value."""
    import numpy as np

    from hpvaegan_tpu_torch.parallel.sampling import _per_sample_stats

    rng = np.random.RandomState(SEED)
    feats = torch.from_numpy((rng.randn(4, 64, 3, 12, 16) + 0.5)
                             .astype(np.float32))
    with exact_math(torch):
        card = [t.cpu() for t in _per_sample_stats(feats.cuda())]
    host = _per_sample_stats(feats)
    errs = {name: float((c - h).abs().max() / h.abs().max())
            for name, c, h in zip(("mu", "sigma"), card, host)}
    check(all(e <= 1e-5 for e in errs.values()),
          f"per-sample stats card vs CPU {errs} (rtol 1e-5)")
    print("  (a) per-sample (mu, sigma), card vs CPU (TF32 off), max |diff| "
          "/ max: " + json.dumps(errs), flush=True)
    return errs


def ms_netd_names(sd):
    """The reference's p2m_WDiscriminator_2d names (pt2ms.py:8-27) of a
    WDiscriminator state_dict: what a MindSpore netD file holds."""
    out = {}
    for key, value in sd.items():
        value = value.cpu().numpy()
        if key.startswith("body.block"):
            i, rest = key[len("body.block"):].split(".", 1)
            key = f"body.0.{i}.{rest}" if i != "0" else f"body.0.{rest}"
        key = key.replace("conv.", "0.", 1).replace("weight_orig", "weight")
        if key.endswith(("weight_u", "weight_v")):
            value = value.reshape(-1, 1)
        out[key] = value
    return out


def phase_interop(torch, k1, ckpt, run):
    """Phase 17 (b): a .pth and a MindSpore copy of the full-width image
    generator, loaded for eval and resumed for training."""
    import numpy as np

    from hpvaegan_tpu_torch import evaluation, models, train_image
    from hpvaegan_tpu_torch.models.blocks import init_weights_
    from hpvaegan_tpu_torch.tools.convert import from_jax, t2m_HPVAEGAN
    from hpvaegan_tpu_torch.tools.ms_ckpt import save_ms_checkpoint

    image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
    cfg = full_width_config(image_path=image)
    exp = os.path.join(run, "interop")
    os.makedirs(exp)
    write_experiment(exp, cfg, ckpt)
    sd = from_jax(ckpt["params"], ckpt["state"])
    pth = os.path.join(exp, "netG.pth")
    torch.save({"scale": cfg.stop_scale, "state_dict": sd,
                "noise_amps": cfg.Noise_Amps}, pth)
    ms = os.path.join(exp, "netG_ms.ckpt")
    t0 = time.perf_counter()
    save_ms_checkpoint(t2m_HPVAEGAN(sd, 2), ms)
    ms_write_s = time.perf_counter() - t0
    D = models.get_discriminator(cfg.discriminator, 2)(cfg)
    init_weights_(D, torch.Generator().manual_seed(SEED))
    save_ms_checkpoint(ms_netd_names(D.state_dict()),
                       os.path.join(exp, f"netD_{cfg.stop_scale - 1}.ckpt"))

    def samples(netG):
        c = evaluation.hydrate_config(exp, dict(
            niter=1, num_samples=8, scale_idx=-1, netG=netG))
        t0 = time.perf_counter()
        gen, _ = evaluation.load_generator(c, exp, netG=netG, device="cuda")
        load_s = time.perf_counter() - t0
        with exact_math(torch):
            out = evaluation.generate_samples(c, gen, seed=SEED)
        return out, load_s

    want, pickle_s = samples("")
    loads = {"pickle_load_s": round(pickle_s, 3),
             "ms_write_s": round(ms_write_s, 3)}
    for name, path in (("pth", pth), ("ms", ms)):
        got, load_s = samples(path)
        check(got.shape == want.shape == (8,) + image_size(cfg) + (3,),
              f"{name} samples {got.shape}")
        diff = float(np.abs(got - want).max())
        check(diff == 0.0, f"{name} route differs from the pickle's by "
              f"{diff}")
        loads[f"{name}_load_s"] = round(load_s, 3)
    print("  (b) load_generator from netG.pth and a MindSpore netG: 8 "
          "samples each equal to the pickled pytree's bit for bit "
          "(deterministic cuDNN); " + json.dumps(loads), flush=True)

    k1.fused_upscale_noise_2d.launches = 0
    t0 = time.perf_counter()
    new = train_image.main(image_train_args(
        os.path.join(run, "resumed"), "--niter", "2", "--netG", ms,
        "--intermediate", os.path.join(exp, "intermediate.json")))
    resume_s = time.perf_counter() - t0
    k = cfg.stop_scale
    files = set(os.listdir(new))
    check({f"netG_{k}.ckpt", f"netD_{k}.ckpt"} <= files
          and not any(f.startswith(f"netG_{k - 1}") for f in files),
          f"resumed experiment {sorted(files)}")
    with open(os.path.join(new, "intermediate.json")) as f:
        inter = json.load(f)
    check(inter["scale_idx"] == k and inter["noise_amps"][:k]
          == cfg.Noise_Amps[:k] and math.isfinite(inter["noise_amps"][k]),
          f"intermediate.json {inter}")
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == 0, f"the resume launched K1 {launches} times")
    print(f"  (b) train_image --netG <MindSpore netG_{k}> (D from a "
          f"MindSpore netD_{k - 1}): scale {k} retrained, 2 iterations, "
          f"{resume_s:.1f} s, amp {inter['noise_amps'][k]:.5f}, K1 launches "
          "0", flush=True)
    return {"loads": loads, "resume_s": resume_s}


def phase_ondevice(torch, k1, ckpt):
    """Phase 17 (module doc)."""
    from hpvaegan_tpu_torch import eval_image, eval_video

    out = {"stats": stats_card_vs_cpu(torch)}
    with tempfile.TemporaryDirectory(prefix="hpv_od_") as run:
        image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
        cfg = full_width_config(image_path=image)
        exp = os.path.join(run, "image")
        os.makedirs(exp)
        write_experiment(exp, cfg, ckpt)
        out["image"] = ondevice_eval(torch, k1, eval_image.main, exp,
                                     "SIFID", (3,) + image_size(cfg))
        vcfg, _ = video_config()
        exp = os.path.join(run, "video")
        os.makedirs(exp)
        write_experiment(exp, vcfg, random_jax_checkpoint(vcfg, SEED,
                                                          ndim=3))
        t, h, w = video_sizes(vcfg)[-1]
        out["video"] = ondevice_eval(torch, k1, eval_video.main, exp,
                                     "SVFID", (3, t, h, w))
        out["interop"] = phase_interop(torch, k1, ckpt, run)
    return out


def serving_card_vs_cpu(torch):
    """Phase 18 (a): a tiny ServingModule on the card (TF32 off) against
    the CPU from the same weights, noise and seed."""
    import numpy as np

    from hpvaegan_tpu_torch.data.video import SingleVideoDataset
    from hpvaegan_tpu_torch.export.serving import (ServingModule,
                                                   serving_input_specs)
    from hpvaegan_tpu_torch.models import get_generator
    from hpvaegan_tpu_torch.models.blocks import init_weights_

    out = {}
    for ndim, batch in ((2, 2), (3, 1)):
        kw = {}
        if ndim == 3:
            kw = dict(video_path=os.path.join(HERE, "data", "vids",
                                              "synthetic.avi"),
                      max_frames=5, sampling_rates=[2, 1])
        cfg = tiny_config(**kw)
        if ndim == 3:
            SingleVideoDataset(cfg, "cpu")  # sets org_fps, ar, fps_lcm
        gen = get_generator(cfg.generator, ndim)(cfg)
        for _ in range(cfg.stop_scale):
            gen.init_next_stage()
        init_weights_(gen, torch.Generator().manual_seed(SEED))
        rng = np.random.RandomState(SEED)
        specs = serving_input_specs(cfg, ndim, batch)
        z = torch.from_numpy(rng.standard_normal(specs[0].shape)
                             .astype(np.float32))
        amps = torch.from_numpy(rng.uniform(0.1, 1.0, specs[1].shape)
                                .astype(np.float32))
        seed = torch.tensor(7, dtype=torch.int32)
        with torch.no_grad():
            want = ServingModule(gen)(z, amps, seed)
            with exact_math(torch):
                got = ServingModule(gen.to("cuda"))(
                    z.cuda(), amps.cuda(), seed.cuda()).cpu()
        diff = float((got - want).abs().max())
        check(diff <= 1e-4, f"{ndim}D serving: card vs CPU {diff} > 1e-4")
        out[f"{ndim}d_b{batch}"] = diff
    print("  (a) tiny ServingModule, card vs CPU (TF32 off): max |diff| "
          + json.dumps(out), flush=True)
    return out


def runner_latency(stdout):
    """The runner's `NN inference cost average time: X ms of infer_count
    N` line -> (X, N)."""
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith("NN inference cost average time: ")]
    check(len(lines) == 1, f"runner printed {stdout!r}")
    words = lines[0].split()
    return float(words[5]), int(words[-1])


def export_experiments(exps, meanwhile=None):
    """Phase 18 (b): `python -m hpvaegan_tpu_torch.export` on each
    experiment, 8 noise bins each, the processes side by side (their
    AOTInductor compiles are builds, run together as the kernels' are);
    `meanwhile()` runs in this process while they work. Returns each
    one's {export_s, aoti_compile_s, export_peak_gb} as the CLI prints
    them."""
    import re

    procs = [subprocess.Popen(
        [sys.executable, "-m", "hpvaegan_tpu_torch.export", "--exp-dir",
         exp, "--num-samples", str(SERVE_BINS)], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for exp in exps]
    out = []
    try:
        if meanwhile is not None:
            meanwhile()
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=1000)
            check(proc.returncode == 0, f"export CLI exit {proc.returncode}:"
                  f" {stderr[-3000:]}")
            got = {}
            for ln in stdout.splitlines():
                m = re.match(r"(exported|compiled) \S+ in ([0-9.]+) s, peak "
                             r"([0-9.]+) GB", ln)
                if m:
                    got[m.group(1)] = (float(m.group(2)), float(m.group(3)))
            check(set(got) == {"exported", "compiled"},
                  f"export CLI printed {stdout!r}")
            out.append({"export_s": got["exported"][0],
                        "aoti_compile_s": got["compiled"][0],
                        "export_peak_gb": got["compiled"][1]})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def serve_tiny(torch, exp, runner_build):
    """Phase 18 (b): the runner on the tiny model's package against its
    ExportedProgram on the same bins (TF32 off), atol 1e-4."""
    import glob

    import numpy as np

    from hpvaegan_tpu_torch.export.serving import (load_serialized,
                                                   run_serialized)
    from hpvaegan_tpu_torch.tools.run_infer import run_runner

    infer = os.path.join(exp, "infer")
    runner_build.join()
    check(runner_build.error is None, f"runner build: {runner_build.error}")
    run_runner(exp)
    program = load_serialized(glob.glob(os.path.join(infer, "*[0-9].pt2"))[0])
    with open(os.path.join(infer, "io_spec.txt")) as f:
        z_shape = tuple(int(d) for d in f.readline().split()[1].split(","))
    amps = np.fromfile(os.path.join(infer, "noise_amps", "noise_amps.bin"),
                       np.float32)
    seed = np.fromfile(os.path.join(infer, "seed", "seed.bin"), np.int32)[0]
    bins = sorted(glob.glob(os.path.join(infer, "noise_init", "*.bin")))
    diff = 0.0
    with exact_math(torch):
        for b in bins:
            want = run_serialized(program, np.fromfile(b, np.float32).reshape(
                z_shape), amps, seed).cpu().numpy()
            got = np.fromfile(os.path.join(infer, "result", os.path.basename(
                b)[:-4] + "_output_0.bin"), np.float32).reshape(want.shape)
            diff = max(diff, float(np.abs(got - want).max()))
    check(len(bins) == SERVE_BINS and diff <= 1e-4,
          f"tiny model: runner vs ExportedProgram {diff} over {len(bins)}")
    print(f"  (b) tiny model, {len(bins)} bins: runner vs ExportedProgram "
          f"max |diff| {diff} (TF32 off)", flush=True)
    return diff


def serve_experiment(torch, k1, exp, ndim, runner_build, exported_info):
    """Phase 18 (b) on one exported experiment dir (module doc)."""
    import glob

    import numpy as np
    from torch._inductor import aoti_load_package

    from hpvaegan_tpu_torch import evaluation, postprocess
    from hpvaegan_tpu_torch.export.serving import (ServingModule,
                                                   load_serialized,
                                                   run_serialized)
    from hpvaegan_tpu_torch.tools.run_infer import run_runner

    n = SERVE_BINS
    k1.fused_upscale_noise_2d.launches = 0
    infer = os.path.join(exp, "infer")
    pt2, aoti = (os.path.join(infer, "netG_9" + ext)
                 for ext in (".pt2", ".aoti.pt2"))
    with open(os.path.join(infer, "io_spec.txt")) as f:
        spec = f.read().splitlines()
    z_shape = tuple(int(d) for d in spec[0].split()[1].split(","))
    bins = sorted(glob.glob(os.path.join(infer, "noise_init", "*.bin")))
    check(len(bins) == n and spec[1:] == ["f32 11", "s32"],
          f"bins {len(bins)}, io_spec {spec}")
    noises = [np.fromfile(b, np.float32).reshape(z_shape) for b in bins]
    amps = np.fromfile(os.path.join(infer, "noise_amps", "noise_amps.bin"),
                       np.float32)
    seed = np.fromfile(os.path.join(infer, "seed", "seed.bin"), np.int32)[0]
    amps_t = torch.from_numpy(amps).cuda()
    seed_t = torch.tensor(seed).cuda()

    # the eager module, the ExportedProgram and the AOTInductor package in
    # this process, float32 convolutions (TF32 off)
    cfg = evaluation.hydrate_config(exp, dict(scale_idx=-1))
    gen, _ = evaluation.load_generator(cfg, exp, ndim=ndim, device="cuda")
    module = ServingModule(gen)
    program = load_serialized(pt2)
    package = aoti_load_package(aoti)

    def maxdiff(a, b):
        return max(float(np.abs(x - y).max()) for x, y in zip(a, b))

    with exact_math(torch), torch.no_grad():
        eager = module(torch.from_numpy(noises[0]).cuda(), amps_t,
                       seed_t).cpu().numpy()
        exported = [run_serialized(program, z, amps, seed).cpu().numpy()
                    for z in noises]
        compiled = [package(torch.from_numpy(z).cuda(), amps_t,
                            seed_t).cpu().numpy() for z in noises]
        # the model's own float32 sensitivity: each element of noise_init
        # moved by about one ulp (a relative 2^-23 of either sign)
        rng = np.random.RandomState(SEED)
        nudged = noises[0] * (1 + np.where(rng.rand(*z_shape) < 0.5, 1, -1)
                              * 2.0 ** -23).astype(np.float32)
        eager_nudged = module(torch.from_numpy(nudged).cuda(), amps_t,
                              seed_t).cpu().numpy()
    check(bool(np.isfinite(exported[0]).all())
          and float(np.abs(exported[0]).max()) <= 1.0, "bad samples")

    def eager_ms(tf32):
        """Warm per-inference ms of the eager module over the n bins: h2d
        + forward + d2h, synchronised."""
        times = []
        flags = contextlib.nullcontext() if tf32 else exact_math(torch)
        with flags, torch.no_grad():
            for z in noises[:1] + noises:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                module(torch.from_numpy(z).cuda(), amps_t, seed_t).cpu()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        return sum(times[1:]) / n

    torch.cuda.reset_peak_memory_stats()
    eager_f32 = eager_ms(False)
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    eager_tf32 = eager_ms(True)

    runner_build.join()
    check(runner_build.error is None, f"runner build: {runner_build.error}")
    runner_f32 = runner_latency(run_runner(exp))
    check(runner_f32[1] == n, f"runner ran {runner_f32[1]} of {n}")
    outs = sorted(glob.glob(os.path.join(infer, "result", "*.bin")))
    check(len(outs) == n, f"{len(outs)} runner outputs")
    runner = [np.fromfile(o, np.float32).reshape(e.shape)
              for o, e in zip(outs, exported)]
    runner_tf32 = runner_latency(run_runner(exp, allow_tf32=True))
    diffs = {"program_vs_eager": maxdiff([eager], exported[:1]),
             "eager_input_one_ulp": maxdiff([eager], [eager_nudged]),
             "package_vs_program": maxdiff(compiled, exported),
             "runner_vs_package": maxdiff(runner, compiled),
             "runner_vs_program": maxdiff(runner, exported)}
    print("  (b) max |diff| over the bins (TF32 off): " + json.dumps(diffs),
          flush=True)

    metric = "SIFID" if ndim == 2 else "SVFID"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        postprocess.main(["--exp-dir", exp])
    post_s = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith(f"{metric}: ")]
    check(len(lines) == 1, f"postprocess printed {buf.getvalue()!r}")
    value = float(lines[0].split()[1])
    check(math.isfinite(value) and value >= 0, f"{metric} {value}")
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == 0, f"the serving path launched K1 {launches} times")
    for name, tol in (("program_vs_eager", 1e-4), ("runner_vs_package", 1e-4),
                      ("runner_vs_program", FULL_WIDTH_COMPILED_TOL)):
        check(diffs[name] <= tol, f"{name} {diffs[name]} > {tol}")
    out = {"z": list(z_shape), "out": list(exported[0].shape),
           **exported_info,
           "pt2_mb": round(os.path.getsize(pt2) / 1e6, 2),
           "aoti_pt2_mb": round(os.path.getsize(aoti) / 1e6, 2),
           "runner_ms_f32": runner_f32[0], "runner_ms_tf32": runner_tf32[0],
           "eager_ms_f32": round(eager_f32, 3),
           "eager_ms_tf32": round(eager_tf32, 3),
           "eager_peak_gb": round(eager_peak, 3),
           "postprocess_s": round(post_s, 2), metric: value,
           "k1_launches": launches}
    print(f"  (b) {ndim}D export and serving, {n} bins: " + json.dumps(out),
          flush=True)
    return out


CHILDREN = []  # the processes this script starts, ended at its exit


@atexit.register
def end_children():
    import signal

    for proc in CHILDREN:
        if getattr(proc, "own_group", False):
            try:  # its children too: torchrun's ranks
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if proc.poll() is None:
            proc.kill()
        proc.wait()


class DrawsCheck:
    """Phase 18 (c) in a process of its own (`--serving-draws`), started
    with phase 18's export CLIs, so that its AOTInductor compile runs
    beside theirs and beside no timed phase."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="hpv_draws_")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serving-draws",
             self.dir], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        CHILDREN.append(self.proc)

    def result(self):
        log, _ = self.proc.communicate(timeout=900)
        check(self.proc.returncode == 0, f"serving draws: {log[-3000:]}")
        with open(os.path.join(self.dir, "draws.json")) as f:
            out = json.load(f)
        shutil.rmtree(self.dir)
        return out


class RunnerBuild(threading.Thread):
    """The native runner's g++ build, started beside the kernels' nvcc."""

    def __init__(self):
        super().__init__(daemon=True)
        self.error = None
        self.seconds = None

    def run(self):
        from hpvaegan_tpu_torch.native import build

        t0 = time.perf_counter()
        try:
            build.build()
        except Exception as e:  # reported by the phase that joins
            self.error = e
        self.seconds = time.perf_counter() - t0


def stage_draw_shapes(cfg, ndim):
    """The refinement draws of one serving sample (port layout, batch 1,
    nc_im channels), one per stage 1..stop_scale."""
    from hpvaegan_tpu_torch.utils import pyramid

    out = []
    for k in range(1, cfg.stop_scale + 1):
        h, w = pyramid.scale_size_2d(k, cfg.scale_factor, cfg.stop_scale,
                                     cfg.img_size, cfg.ar)
        if ndim == 2:
            out.append((1, cfg.nc_im, h, w))
        else:
            td = pyramid.get_fps_td_by_index(
                k, cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps,
                cfg.fps_lcm)[1]
            out.append((1, cfg.nc_im, td, h, w))
    return out


def serving_draws_worker(out_dir):
    """Phase 18 (c), run as `chip_smoke.py --serving-draws <dir>` from the
    start of the script: the serving module's draw chain (ServingModule's
    key splits, then utils/noise.py::KeyedNoise drawing up front, as the
    traced serving forward does: one draw at each stage of the full-width
    image and video models), exported and
    compiled by AOTInductor for the card, run at three seeds and held bit
    for bit to utils/jax_prng.py's numpy path (XLA:CPU's arithmetic).
    Writes draws.json into out_dir."""
    import numpy as np
    import torch
    from PIL import Image

    from hpvaegan_tpu_torch.export.serving import compile_native
    from hpvaegan_tpu_torch.utils import jax_prng
    from hpvaegan_tpu_torch.utils.noise import KeyedNoise

    image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
    cfg = full_width_config(image_path=image)
    with Image.open(image) as im:
        cfg.ar = im.height / im.width
    vcfg, _ = video_config()
    shapes = stage_draw_shapes(cfg, 2) + stage_draw_shapes(vcfg, 3)

    class Draws(torch.nn.Module):
        """ServingModule's key chain and its traced forward's draws: all
        of them up front, through one erfinv."""

        def forward(self, seed):
            keys = jax_prng.split(jax_prng.prng_key(seed)[None], 2)
            noise = KeyedNoise(keys[:, -1], shapes=shapes)
            return tuple(noise.normal(s) for s in shapes)

    seed0 = torch.tensor(0, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    exported = torch.export.export(Draws(), (seed0,))
    package = torch._inductor.aoti_load_package(compile_native(
        exported, os.path.join(out_dir, "draws.aoti.pt2")))
    compile_s = time.perf_counter() - t0
    out = {"draws": len(shapes), "compile_s": round(compile_s, 1),
           "elements": 0, "bits_differ": 0}
    for seed in (0, 11, 2 ** 31 - 1):
        got = package(torch.tensor(seed, dtype=torch.int32, device="cuda"))
        keys = jax_prng.split(jax_prng.prng_key(torch.tensor(
            seed, dtype=torch.int32))[None], 2)[:, -1]
        for shape, g in zip(shapes, got):
            pairs = jax_prng.split(keys)
            keys, sub = pairs[:, 0], pairs[0, 1]
            want = jax_prng.normal((int(sub[0]), int(sub[1])),
                                   KeyedNoise._channels_last(shape))
            want = np.moveaxis(want, -1, 1)
            g = g.cpu().numpy()
            out["elements"] += int(want.size)
            out["bits_differ"] += int((g.view(np.int32)
                                       != want.view(np.int32)).sum())
    with open(os.path.join(out_dir, "draws.json"), "w") as f:
        json.dump(out, f)


def phase_serving(torch, k1, ckpt, runner_build, meanwhile=None):
    """Phase 18 (module doc); `meanwhile()` runs beside the export CLIs."""
    from PIL import Image

    out = {"card_vs_cpu": serving_card_vs_cpu(torch)}
    with tempfile.TemporaryDirectory(prefix="hpv_serve_") as run:
        image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
        cfg = full_width_config(image_path=image)
        with Image.open(image) as im:
            cfg.ar = im.height / im.width  # as training sets it
        vcfg, _ = video_config()
        tiny = tiny_config(image_path=image)
        tiny.scale_idx = tiny.stop_scale
        tiny.Noise_Amps = [1.0] + [0.3] * tiny.stop_scale
        exps = [os.path.join(run, name) for name in ("image", "video",
                                                     "tiny")]
        for exp, c, ndim in zip(exps, (cfg, vcfg, tiny), (2, 3, 2)):
            os.makedirs(exp)
            write_experiment(exp, c, ckpt if c is cfg else
                             random_jax_checkpoint(c, SEED, ndim=ndim))
        t0 = time.perf_counter()
        draws_check = DrawsCheck()
        info = export_experiments(exps, meanwhile)
        print(f"  (b) export CLI on the three experiments side by side "
              f"(beside (c)'s compile"
              f"{' and phase 22 (a) at scale 9' if meanwhile else ''}): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["draws"] = draws_check.result()
        print("  (c) the AOTInductor package's normals against the numpy "
              "path (compiled beside the export CLIs; joined "
              f"{time.perf_counter() - t0:.1f} s after they started): "
              + json.dumps(out["draws"]), flush=True)
        check(out["draws"]["bits_differ"] == 0,
              f"the compiled draws differ in {out['draws']['bits_differ']} "
              "elements")
        out["tiny"] = serve_tiny(torch, exps[2], runner_build)
        out["image"] = serve_experiment(torch, k1, exps[0], 2, runner_build,
                                        info[0])
        print(f"  runner build (g++, beside phase 1): "
              f"{runner_build.seconds:.1f} s", flush=True)
        out["video"] = serve_experiment(torch, k1, exps[1], 3, runner_build,
                                        info[1])
    return out

# phase 19: the data-parallel ranks of one card (gloo: NCCL takes one card
# per rank) and the run they are held to
DP_RANKS = 2
DP_ITERS = 4  # at scale 9: 1 compared, 2 timed, 1 with its phases timed
DP_SAMPLES = 64
DP_SCALE = 9
DP_DEVICE = "cuda"
# phase 19's bar for training against one process: the random full-width
# model amplifies a rounding about a thousandfold (phase 18: one ulp of its
# input moves its output by ~2e-3), and the first iteration over NCCL as
# one rank, the same arithmetic but for the order of BatchNorm's sums,
# already moves G's gradients by 1.7e-3 and the metrics by 9.6e-4 on an
# H100 (two gloo ranks: 1.85e-3). Each fault planted in (c) moves G's
# gradients by 0.149 (not averaged), 0.173 (BatchNorm not reduced) or
# 0.210 (another rank's draws) there, so the bar sits 5x above the sound
# runs and 15x below the faults; (c) fails if a fault reads under it.
DP_TRAIN_REL = 1e-2
# seconds the rank processes of one launch may take (join_in_group)
RANKS_TIMEOUT = 600


def param_diffs(a, b):
    """(max |diff| over the parameters, max relative |diff| over the
    BatchNorm running statistics) of two state dicts."""
    par = [float((a[k] - b[k]).abs().max()) for k in a
           if "running_" not in k]
    run = [float(((a[k] - b[k]).abs() / b[k].abs().clamp_min(1e-3)).max())
           for k in a if "running_" in k]
    return max(par), max(run, default=0.0)


def grads_rel(a, b):
    """||a - b|| / ||b|| over all the gradients of a module at once."""
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    return math.sqrt(num / sum(float((v ** 2).sum()) for v in b.values()))


def metrics_rel(a, b):
    """The largest |a - b| / max(|b|, 1e-2) over the logged metrics."""
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-2) for k in b)


def first_iteration_rel(got, want):
    """The first iteration's metrics and gradients of `got` against
    `want`: what DP_TRAIN_REL bounds."""
    return {"metrics_rel_iter1": metrics_rel(got["metrics"], want["metrics"]),
            "G_grads_rel_iter1": grads_rel(got["G_grads"], want["G_grads"]),
            "D_grads_rel_iter1": grads_rel(got["D_grads"], want["D_grads"])}


# phase 19 (c): the faults planted in a rank, each undoing one of the
# three things that make N ranks one process (parallel/mesh.py)
DP_FAULTS = ("grads_not_averaged", "bn_not_reduced", "draws_not_sliced")


def plant_fault(fault):
    """Undo one part of the data axis in this process: the gradients'
    mean (training/steps.py::_set_grads without it), BatchNorm's sum
    over the ranks (ops/norm.py never handed one), or the slicing of the
    global draws (every rank draws rows [0, b), the first rank's)."""
    from hpvaegan_tpu_torch.ops import norm
    from hpvaegan_tpu_torch.training import steps
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    if fault == "grads_not_averaged":
        def set_grads(params, loss):
            import torch

            grads = torch.autograd.grad(loss, params, materialize_grads=True)
            for p, g in zip(params, grads):
                p.grad = g
        steps._set_grads = set_grads
    elif fault == "bn_not_reduced":
        norm.set_group_sum = lambda group_sum: None
    elif fault == "draws_not_sliced":
        NoiseSource._rows = lambda self, b: (b, 0)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def collective_calls(mesh) -> int:
    """The collectives this process has issued, summed over their kinds."""
    return sum(calls for calls, _ in mesh.collectives().values())


def exchange_ms(torch, iteration):
    """Runs `iteration` with the program's phases on (utils/profiling.py);
    returns its result and its device ms in the gradients' exchange
    (phases d.exchange and g.exchange), timed by CUDA events that add no
    synchronisation of their own."""
    from hpvaegan_tpu_torch.utils import profiling

    profiling.enable(True)
    try:
        result = iteration()
    finally:
        profiling.enable(False)
    torch.cuda.synchronize()
    phases = profiling.phase_ms()
    return result, phases["d.exchange"] + phases["g.exchange"]


def dp_train_leg(torch, group, first_only=False):
    """DP_ITERS full-width training iterations at scale 9 (GAN) of a global
    batch of 2, under `group` (a rank's share of it, or the whole in one
    process). Returns the first iteration's metrics and gradients (the
    step is then the same arithmetic in both, up to the order of float32
    sums; after it Adam's first update, lr * sign(g), turns a gradient
    that is zero up to rounding into +-lr, so later parameters differ by
    ~2 lr per step in a few elements and are only reported), G's and
    D's state after all the iterations, the steps/s of iterations 2 and 3,
    and iteration 4's device ms in the gradients' exchange (`exchange_ms`)."""
    from hpvaegan_tpu_torch.data.image import SingleImageDataset
    from hpvaegan_tpu_torch.parallel import mesh
    from hpvaegan_tpu_torch.tools.step_parity import build_state
    from hpvaegan_tpu_torch.training.steps import (batch_former,
                                                   train_iteration)
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
    cfg = full_width_config(image_path=image, batch_size=2)
    dataset = SingleImageDataset(cfg, DP_DEVICE)
    amps = [1.0] + [0.05] * (cfg.stop_scale + 1)
    st = build_state(cfg, DP_SCALE, SEED, DP_DEVICE)
    data = dataset.scale_image(DP_SCALE), dataset.scale_image(0)
    former = batch_former(2, DP_SCALE)

    def iteration():
        return {k: float(v) for k, v in train_iteration(
            cfg, st, data[0], data[1], amps, False, former).items()}

    def grads(module):
        return {k: p.grad.detach().cpu().clone()
                for k, p in module.named_parameters() if p.grad is not None}

    with mesh.data_parallel(group):
        st.noise = NoiseSource(SEED, DP_DEVICE)
        first = iteration()
        out = {"metrics": first, "G_grads": grads(st.G),
               "D_grads": grads(st.D)}
        if first_only:
            return out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            metrics = iteration()
        torch.cuda.synchronize()
        out["steps_per_s"] = 2 / (time.perf_counter() - t0)
        metrics, out["exchange_ms"] = exchange_ms(torch, iteration)
    check(all(math.isfinite(v) for v in metrics.values()),
          f"data-parallel metrics {metrics}")
    out["G"] = {k: v.cpu() for k, v in st.G.state_dict().items()}
    out["D"] = {k: v.cpu() for k, v in st.D.state_dict().items()}
    return out


def train_parity(got, want, what):
    """The first iteration's metrics and gradients of `got` against `want`,
    each within DP_TRAIN_REL; the parameters (max |diff|) and BatchNorm
    running statistics (max relative diff) after DP_ITERS iterations,
    reported."""
    g_par, g_run = param_diffs(got["G"], want["G"])
    d_par, d_run = param_diffs(got["D"], want["D"])
    out = {**first_iteration_rel(got, want),
           f"G_param_max_diff_after_{DP_ITERS}": g_par,
           f"G_running_stats_max_rel_after_{DP_ITERS}": g_run,
           f"D_param_max_diff_after_{DP_ITERS}": d_par,
           f"D_running_stats_max_rel_after_{DP_ITERS}": d_run}
    check(max(out["metrics_rel_iter1"], out["G_grads_rel_iter1"],
              out["D_grads_rel_iter1"]) <= DP_TRAIN_REL, f"{what}: {out}")
    return out


def dp_eval_leg(torch, exp, mesh_data):
    """The eval CLI's --on-device-fid SIFID of DP_SAMPLES samples on `exp`
    (evaluation.eval_image_experiment, which shards over the ranks)."""
    from hpvaegan_tpu_torch.evaluation import (eval_image_experiment,
                                               hydrate_config)

    cfg = hydrate_config(exp, dict(
        niter=1, data_rep=1, batch_size=1, num_samples=DP_SAMPLES,
        max_samples=4, save_path="images", scale_idx=-1,
        mesh_data=mesh_data, on_device_fid=True, netG=""))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = eval_image_experiment(cfg, exp, seed=SEED, device=DP_DEVICE)[0]
    return {"SIFID": value, "s": time.perf_counter() - t0}


def dp_sampler_leg(torch, k1, exp, group):
    """The moving-stat sampler with pallas_fused_sampling on `exp`'s
    generator: DP_SAMPLES samples over `group`, gathered; K1's launches on
    this rank."""
    from hpvaegan_tpu_torch.evaluation import hydrate_config, load_generator
    from hpvaegan_tpu_torch.parallel import mesh, multihost
    from hpvaegan_tpu_torch.parallel.sampling import sharded_sampler
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    cfg = hydrate_config(exp, dict(scale_idx=-1, netG=""))
    gen = load_generator(cfg, exp, device=DP_DEVICE)[0]
    cfg.pallas_fused_sampling = True
    with mesh.data_parallel(group), torch.no_grad():
        sample = sharded_sampler(cfg, gen, train=False)
        sample(DP_SAMPLES, NoiseSource(SEED + 1, DP_DEVICE))  # warm
        k1.fused_upscale_noise_2d.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        local = sample(DP_SAMPLES, NoiseSource(SEED, DP_DEVICE))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = k1.fused_upscale_noise_2d.launches
        full = multihost.to_host(local) if group.group is not None \
            else local.cpu().numpy()
    return {"samples": full, "rows": int(local.shape[0]),
            "launches": launches, "s": secs}


def dp_video_leg(torch, exp):
    """The full-width video model's per-sample-BN sampler (eval_video's
    default) on DP_SAMPLES clips, which one process runs as two
    sub-batches of 32 (parallel/sampling.py): this rank's clips, under
    the data group in force."""
    from hpvaegan_tpu_torch.evaluation import (eval_z_tail, hydrate_config,
                                               load_generator)
    from hpvaegan_tpu_torch.parallel import sampling
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    cfg = hydrate_config(exp, dict(scale_idx=-1, netG=""))
    gen = load_generator(cfg, exp, ndim=3, device=DP_DEVICE)[0]
    z_tail = eval_z_tail(cfg, 3)
    sample = sampling.sharded_sampler(cfg, gen, ndim=3, z_tail=z_tail)
    per = sampling.generator_elements(cfg, gen, 3, z_tail)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        rows = sample(DP_SAMPLES, NoiseSource(SEED, DP_DEVICE))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = {"rows": rows.cpu().numpy(), "s": secs,
           "sub_batches": sampling.sub_batches(DP_SAMPLES, per)}
    del rows, gen
    torch.cuda.empty_cache()
    return out


def dp_worker(rank, port, work, fault=None):
    """One rank of phase 19 (b), run as `chip_smoke.py --dp-worker <rank>
    <port> <dir>`: the three legs over two gloo ranks on the card; with a
    fault (one of DP_FAULTS) after <dir>, (c): that fault planted, the
    training leg's first iteration only."""
    import torch

    from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1
    from hpvaegan_tpu_torch.parallel import mesh, multihost

    device = mesh.select_device(DP_DEVICE, 0)
    multihost.init_distributed(f"127.0.0.1:{port}", DP_RANKS, rank,
                               backend="gloo", device=device)
    group = mesh.make_data_group(DP_RANKS)
    exp = os.path.join(work, "image")
    out = {"backend": torch.distributed.get_backend()}
    with exact_math(torch):
        if fault:
            plant_fault(fault)
            out["train"] = dp_train_leg(torch, group, first_only=True)
        else:
            out["train"] = dp_train_leg(torch, group)
            out["eval"] = dp_eval_leg(torch, exp, DP_RANKS)
            out["sampler"] = dp_sampler_leg(torch, k1, exp, group)
            with mesh.data_parallel(group):
                out["video"] = dp_video_leg(
                    torch, os.path.join(work, "video"))
    torch.save(out, os.path.join(work, f"dp_{fault or 'sound'}_{rank}.pt"))
    multihost.sync()
    torch.distributed.destroy_process_group()


def nccl_one_rank(torch):
    """Phase 19 (a): the helpers and the data group's collectives under
    NCCL as one rank on the card: the helpers' results, BatchNorm with its
    double backward, and one full-width scale-9 iteration over the
    one-rank group against the same iteration with no group."""
    import torch.distributed as dist

    from hpvaegan_tpu_torch.ops import norm
    from hpvaegan_tpu_torch.parallel import mesh, multihost

    multihost.init_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                               device=mesh.select_device(DP_DEVICE, 0))
    try:
        check(dist.get_backend() == "nccl", dist.get_backend())
        x = torch.arange(6.0, device=DP_DEVICE).reshape(2, 3)
        gathered = multihost.to_host((x, x[:, :1].long()))
        long_raised = False
        try:
            multihost.broadcast_str("x" * 5000, max_len=4096)
        except ValueError:
            long_raised = True
        helpers = (multihost.agree_float(2.5) == 2.5
                   and multihost.agree_seed(7) == 7
                   and multihost.agree_minmax(1.5) == (1.5, 1.5)
                   and multihost.broadcast_str("abc") == "abc"
                   and long_raised
                   and (gathered[0] == x.cpu().numpy()).all()
                   and gathered[1].dtype.name == "int64")
        multihost.sync()
        check(helpers, "NCCL one-rank helpers")
        group = mesh.DataGroup(0, 1, dist.group.WORLD)
        gen = torch.Generator(device=DP_DEVICE).manual_seed(SEED)
        xs = torch.randn(4, 64, 24, 33, device=DP_DEVICE, generator=gen)

        def bn_grads():
            xg = xs.clone().requires_grad_(True)
            gamma = torch.ones(64, device=DP_DEVICE, requires_grad=True)
            y = norm.batchnorm(xg, gamma, torch.zeros(64, device=DP_DEVICE),
                               torch.zeros(64, device=DP_DEVICE),
                               torch.ones(64, device=DP_DEVICE), "batch")[0]
            g, = torch.autograd.grad((y * xs).sum(), xg, create_graph=True)
            return torch.autograd.grad((g ** 2).mean(), (xg, gamma))

        with exact_math(torch):
            want = bn_grads()
            with mesh.data_parallel(group):
                got = bn_grads()
            bn_diff = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
            one = dp_train_leg(torch, mesh.DataGroup())
            nccl = dp_train_leg(torch, group)
        check(bn_diff <= 1e-4, f"NCCL BatchNorm double backward {bn_diff}")
        out = {"helpers": True, "bn_double_backward_max_diff": bn_diff,
               **train_parity(nccl, one, "NCCL one-rank training"),
               "train_steps_per_s_nccl": round(nccl["steps_per_s"], 3),
               "train_steps_per_s_no_group": round(one["steps_per_s"], 3),
               "exchange_ms_nccl": round(nccl["exchange_ms"], 4)}
        print("  (a) NCCL, one rank (TF32 off): " + json.dumps(out),
              flush=True)
        with mesh.data_parallel(group):
            out["chunk"] = nccl_one_rank_chunks(torch)
    finally:
        dist.destroy_process_group()
    return out


def nccl_one_rank_chunks(torch):
    """Phase 19 (a), the chunk in the one-rank NCCL group in force: phase
    22's graph against eager (16 iterations at --steps-per-call 8), the
    collectives in the graph, at full-width 2D scale 9 and 3D scale 2."""
    from hpvaegan_tpu_torch.data.image import SingleImageDataset

    image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
    cfg = full_width_config(image_path=image, batch_size=1)
    dataset = SingleImageDataset(cfg, "cuda")
    mode = "graph (1 NCCL rank)"
    out = {"2d_9": graph_vs_eager(
        torch, "2D GeneratorHPVAEGAN in a one-rank NCCL group", cfg,
        (dataset.scale_image(9), dataset.scale_image(0)), 9, 2,
        want_mode=mode)}
    vcfg, vdata = video_config()
    out["3d_2"] = graph_vs_eager(
        torch, "3D GeneratorHPVAEGAN in a one-rank NCCL group",
        video_at(vcfg, 2), (vdata.scale_frames(2), vdata.scale_frames(0)), 2,
        3, want_mode=mode)
    return out


def free_port():
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def start_ranks(work, fault=None, kind="dp", ranks=DP_RANKS):
    """`ranks` processes of `chip_smoke.py --<kind>-worker <rank> <port>
    <work> [fault]`: the two of phase 19 ("dp") or phase 20 ("sp"), the
    four of phase 20 (d) ("spb") or of --cards ("cards"), with `fault`
    planted in each when given; each in a session of its own, its output
    in <work>/<kind>_<fault or sound>_<rank>.log."""
    port = free_port()
    return [start_in_group(
        [sys.executable, os.path.abspath(__file__), f"--{kind}-worker",
         str(r), str(port), work] + ([fault] if fault else []),
        rank_log(work, kind, fault, r)) for r in range(ranks)]


def rank_log(work, kind, fault, rank):
    return os.path.join(work, f"{kind}_{fault or 'sound'}_{rank}.log")


def join_ranks(torch, procs, work, fault=None, kind="dp", ranks=DP_RANKS):
    """The results of start_ranks' processes, one per rank (join_in_group:
    a failed or late rank fails the run with every rank's log)."""
    join_in_group(procs, [rank_log(work, kind, fault, r)
                          for r in range(ranks)],
                  f"{kind} ranks ({fault or 'sound'})")
    return [torch.load(os.path.join(work, f"{kind}_{fault or 'sound'}_{r}"
                                    ".pt"), weights_only=False)
            for r in range(ranks)]


def start_in_group(cmd, log_path):
    """A process in a session of its own (its children with it), output
    to `log_path`; ended, with its children, at this script's exit."""
    log = open(log_path, "w")
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=log,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    proc.own_group = True
    CHILDREN.append(proc)
    return proc


def join_in_group(procs, logs, what):
    """Wait for `procs` (RANKS_TIMEOUT s in all). Past the limit, or once
    one of them fails: SIGUSR1 to every process (a rank that registered
    the stack dump prints its stacks), then end them all and fail, with
    each one's log's tail."""
    import signal

    deadline = time.monotonic() + RANKS_TIMEOUT
    while any(p.poll() is None for p in procs) \
            and not any(p.poll() for p in procs) \
            and time.monotonic() < deadline:
        time.sleep(0.5)
    if all(p.poll() == 0 for p in procs):
        return
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGUSR1)
    time.sleep(5)
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
        p.wait()
    tails = []
    for r, path in enumerate(logs):
        with open(path) as f:
            tails.append(f"--- {what} process {r} (exit {procs[r].returncode})"
                         f":\n{f.read()[-4000:]}")
    fail(f"{what}: " + ("timed out after " f"{RANKS_TIMEOUT} s" if any(
        p.returncode == -9 for p in procs) else "a process failed")
        + "\n" + "\n".join(tails))


def phase_data_parallel(torch, k1, ckpt):
    """Phase 19 (module doc)."""
    import numpy as np

    out = {"nccl": nccl_one_rank(torch)}
    with tempfile.TemporaryDirectory(prefix="hpv_dp_") as work:
        image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
        cfg = full_width_config(image_path=image)
        exp = os.path.join(work, "image")
        os.makedirs(exp)
        write_experiment(exp, cfg, ckpt)
        vcfg, _ = video_config()
        os.makedirs(os.path.join(work, "video"))
        write_experiment(os.path.join(work, "video"), vcfg,
                         random_jax_checkpoint(vcfg, SEED, ndim=3))
        from hpvaegan_tpu_torch.parallel import mesh

        with exact_math(torch):
            one = {"train": dp_train_leg(torch, mesh.DataGroup()),
                   "eval": dp_eval_leg(torch, exp, 1),
                   "sampler": dp_sampler_leg(torch, k1, exp,
                                             mesh.DataGroup()),
                   "video": dp_video_leg(torch,
                                         os.path.join(work, "video"))}
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = join_ranks(torch, start_ranks(work), work)
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        started = [(f, start_ranks(work, f)) for f in DP_FAULTS]
        faults = {f: join_ranks(torch, procs, work, f)
                  for f, procs in started}
        faults_s = time.perf_counter() - t0
    r0, r1 = ranks
    for part in ("G", "D"):
        same = all(torch.equal(v, r1["train"][part][k])
                   for k, v in r0["train"][part].items())
        check(same, f"the ranks' {part} differ")
    check(r0["train"]["metrics"] == r1["train"]["metrics"],
          "the ranks' metrics differ")
    train = {"ranks": DP_RANKS, "backend": r0["backend"], "batch": 2,
             "scale": DP_SCALE, "iterations": DP_ITERS,
             **train_parity(r0["train"], one["train"],
                            f"{DP_RANKS} ranks vs 1 process"),
             "steps_per_s_2_ranks": round(r0["train"]["steps_per_s"], 3),
             "steps_per_s_1_process": round(one["train"]["steps_per_s"], 3),
             "exchange_ms_rank0": round(r0["train"]["exchange_ms"], 4),
             "exchange_ms_rank1": round(r1["train"]["exchange_ms"], 4)}
    print(f"  (b) full-width scale {DP_SCALE}, global batch 2, {DP_RANKS} "
          "gloo ranks vs 1 process (TF32 off): " + json.dumps(train),
          flush=True)
    sifids = [r["eval"]["SIFID"] for r in ranks]
    check(sifids[0] == sifids[1] and math.isfinite(sifids[0]),
          f"the ranks' SIFIDs {sifids}")
    rel = abs(sifids[0] - one["eval"]["SIFID"]) / abs(one["eval"]["SIFID"])
    check(rel <= 1e-3, f"SIFID 2 ranks {sifids[0]} vs 1 process "
          f"{one['eval']['SIFID']}")
    evals = {"samples": DP_SAMPLES, "SIFID_rank0": sifids[0],
             "SIFID_rank1": sifids[1], "SIFID_1_process": one["eval"]["SIFID"],
             "rel_diff": rel, "s_2_ranks": round(r0["eval"]["s"], 3),
             "s_1_process": round(one["eval"]["s"], 3)}
    print("  (b) eval_image --on-device-fid over 2 ranks: "
          + json.dumps(evals), flush=True)
    samp = [r["sampler"] for r in ranks]
    check(all(s["rows"] == DP_SAMPLES // DP_RANKS for s in samp)
          and np.array_equal(samp[0]["samples"], samp[1]["samples"]),
          "the ranks' gathered samples")
    err = float(np.abs(samp[0]["samples"]
                       - one["sampler"]["samples"]).max())
    launches = [s["launches"] for s in samp]
    check(err <= 1e-4, f"sharded moving-stat sampler vs 1 process: {err}")
    check(launches == [9, 9] and one["sampler"]["launches"] == 9,
          f"K1 launches per rank {launches}, one process "
          f"{one['sampler']['launches']}")
    sampler = {"ranks_x_samples": [DP_RANKS, DP_SAMPLES // DP_RANKS],
               "max_abs_err": err, "k1_launches_per_rank": launches,
               "k1_launches_1_process": one["sampler"]["launches"],
               "s_per_rank": [round(s["s"], 4) for s in samp],
               "s_1_process": round(one["sampler"]["s"], 4)}
    print(f"  (b) moving-stat sampler, pallas_fused_sampling, {DP_RANKS} x "
          f"{DP_SAMPLES // DP_RANKS} vs 1 x {DP_SAMPLES}: "
          + json.dumps(sampler), flush=True)
    vids = [r["video"] for r in ranks]
    check(len(one["video"]["sub_batches"]) > 1,
          f"the video sampler did not split: {one['video']['sub_batches']}")
    verr = float(np.abs(np.concatenate([v["rows"] for v in vids])
                        - one["video"]["rows"]).max())
    check(verr <= 1e-4, f"sharded split video sampler vs 1 process: {verr}")
    video = {"ranks_x_clips": [DP_RANKS, DP_SAMPLES // DP_RANKS],
             "sub_batches_1_process": one["video"]["sub_batches"],
             "max_abs_err": verr,
             "s_per_rank": [round(v["s"], 4) for v in vids],
             "s_1_process": round(one["video"]["s"], 4)}
    print(f"  (b) full-width video sampler, per-sample BN, {DP_RANKS} x "
          f"{DP_SAMPLES // DP_RANKS} vs 1 x {DP_SAMPLES} in sub-batches: "
          + json.dumps(video), flush=True)
    print(f"  (b) the two ranks' processes took {ranks_s:.1f} s", flush=True)
    planted = {}
    for fault, outs in faults.items():
        rels = [first_iteration_rel(o["train"], one["train"]) for o in outs]
        planted[fault] = {k: max(r[k] for r in rels) for k in rels[0]}
        check(max(planted[fault].values()) > DP_TRAIN_REL,
              f"planted fault {fault} reads {planted[fault]}, within "
              f"DP_TRAIN_REL {DP_TRAIN_REL}")
    print(f"  (c) planted faults, first iteration on {DP_RANKS} ranks vs 1 "
          f"process (the larger rank's reading; bar {DP_TRAIN_REL}; the "
          f"three pairs side by side, {faults_s:.1f} s): "
          + json.dumps(planted), flush=True)
    out.update(train=train, eval=evals, sampler=sampler, video=video,
               faults=planted)
    return out


# phase 20: the spatial mesh (--mesh-sp 2): two ranks on the card over gloo
# split H, against this process at the same batch; iterations at scale 9
# per model: 2D 1 compared, 2 timed, 1 with its phases timed; 3D 1
# compared, 1 timed with its phases timed (steps/s read from it)
SP_ITERS = {2: 4, 3: 2}
# phase 20 (c): the faults planted in a rank, each breaking one of the
# exchanges that make S ranks one process (parallel/spatial.py)
SP_FAULTS = ("halo_zeros", "bn_not_summed_over_sp", "draws_first_rows")
# phase 20 (d): the CSG/SG baselines on 4 spatial ranks, where the padded
# stages' edge ranks hold more rows than the middle ones; 2 iterations at
# scale 9 per generator (1 compared, 1 timed with its phases timed),
# and the fault (d) plants: BatchNorm of a padded layout counted as equal
# shards (each rank's count times the ranks)
SPB_RANKS = 4
SPB_GENS = ("GeneratorCSG", "GeneratorSG")
SPB_FAULT = "bn_padded_as_equal"


def plant_sp_fault(fault):
    """Break one exchange of the spatial axis in this process: the halo
    rows (zeros for the neighbours' rows), BatchNorm's sum over the
    spatial ranks (ops/norm.py never handed one: each rank normalises by
    its own rows' statistics), or the draws (every rank takes the first
    rows of H of the global draw)."""
    from hpvaegan_tpu_torch.ops import norm
    from hpvaegan_tpu_torch.parallel import spatial
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    if fault == "halo_zeros":
        import torch

        spatial._neighbour_rows = lambda top, bottom, ax: (
            torch.zeros_like(bottom), torch.zeros_like(top))
    elif fault == "bn_not_summed_over_sp":
        norm.set_sharded_sum = lambda sharded_sum: None
    elif fault == "draws_first_rows":
        def first_rows(self, h, kind, shape, *args):
            draw = getattr(self, kind)
            if not spatial.sharded(h):
                return draw(shape, *args)
            shape = tuple(int(s) for s in shape)
            whole = draw(shape[:-2] + (h, shape[-1]), *args)
            return whole.narrow(-2, 0, shape[-2])
        NoiseSource.draw_rows = first_rows
    elif fault == SPB_FAULT:
        norm._elements = lambda xf, groups, ranks, sharded: (
            xf.numel() // (groups * xf.shape[1]) * ranks)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def sp_train_leg(torch, group, ndim, first_only=False, generator=None):
    """SP_ITERS[ndim] full-width training iterations at scale 9 (GAN) of
    the 2D (air_balloons.jpg, 192x257) or 3D (balloons_pan.avi, 13x192x257)
    model at batch 1, or of the baseline `generator` (GeneratorCSG or
    GeneratorSG against WDiscriminatorBaselines, 3D), under `group` (a
    rank's rows of H, or the whole in one process). Returns the first iteration's metrics and gradients, the
    heights the H-sharded convolutions of that iteration ran on (rows plus
    halos, by height), G's and D's state after all the iterations, the
    steps/s, the last iteration's device ms in the gradients' exchange and
    its collectives' number, and the peak memory allocated."""
    from hpvaegan_tpu_torch.data.image import SingleImageDataset
    from hpvaegan_tpu_torch.parallel import mesh, spatial
    from hpvaegan_tpu_torch.tools.step_parity import build_state
    from hpvaegan_tpu_torch.training.steps import (batch_former,
                                                   train_iteration)
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    if ndim == 2:
        image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
        cfg = full_width_config(image_path=image, batch_size=1)
        dataset = SingleImageDataset(cfg, DP_DEVICE)
        data = dataset.scale_image(DP_SCALE), dataset.scale_image(0)
    else:
        cfg, dataset = video_config(batch_size=1)
        data = dataset.scale_frames(DP_SCALE), dataset.scale_frames(0)
    amps = [1.0] + [0.05] * (cfg.stop_scale + 1)
    models = (generator, "WDiscriminatorBaselines") if generator else ()
    st = build_state(cfg, DP_SCALE, SEED, DP_DEVICE, ndim, *models)
    former = batch_former(ndim, DP_SCALE, baseline=bool(generator))

    def iteration():
        return {k: float(v) for k, v in train_iteration(
            cfg, st, data[0], data[1], amps, False, former).items()}

    def grads(module):
        return {k: p.grad.detach().cpu().clone()
                for k, p in module.named_parameters() if p.grad is not None}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mesh.data_parallel(group):
        st.noise = NoiseSource(SEED, DP_DEVICE)
        spatial.conv_rows.clear()
        metrics = iteration()
        out = {"metrics": metrics, "G_grads": grads(st.G),
               "D_grads": grads(st.D),
               "conv_rows": dict(sorted(spatial.conv_rows.items()))}
        if first_only:
            return out
        timed = SP_ITERS[ndim] - 2
        torch.cuda.synchronize()
        if timed:
            t0 = time.perf_counter()
            for _ in range(timed):
                metrics = iteration()
            torch.cuda.synchronize()
            out["steps_per_s"] = timed / (time.perf_counter() - t0)
        calls = collective_calls(mesh)
        t0 = time.perf_counter()
        metrics, out["exchange_ms"] = exchange_ms(torch, iteration)
        secs = time.perf_counter() - t0
        out["collectives"] = collective_calls(mesh) - calls
        out.setdefault("steps_per_s", 1 / secs)
    check(all(math.isfinite(v) for v in metrics.values()),
          f"spatial-mesh metrics {metrics}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["G"] = {k: v.cpu() for k, v in st.G.state_dict().items()}
    out["D"] = {k: v.cpu() for k, v in st.D.state_dict().items()}
    del st, data, dataset
    torch.cuda.empty_cache()
    return out


def sp_worker(rank, port, work, fault=None):
    """One rank of phase 20 (b), run as `chip_smoke.py --sp-worker <rank>
    <port> <dir>`: the 2D and 3D legs over two gloo ranks on the card
    (--mesh-sp 2); with a fault (one of SP_FAULTS) after <dir>, (c): that
    fault planted, the 2D leg's first iteration only."""
    import torch

    from hpvaegan_tpu_torch.parallel import mesh, multihost

    device = mesh.select_device(DP_DEVICE, 0)
    multihost.init_distributed(f"127.0.0.1:{port}", DP_RANKS, rank,
                               backend="gloo", device=device)
    group = mesh.make_data_group(1, DP_RANKS)
    out = {"backend": torch.distributed.get_backend(),
           "place": (group.sp.rank, group.sp.size)}
    with exact_math(torch):
        if fault:
            plant_sp_fault(fault)
            out["2d"] = sp_train_leg(torch, group, 2, first_only=True)
        else:
            out["2d"] = sp_train_leg(torch, group, 2)
            out["3d"] = sp_train_leg(torch, group, 3)
    torch.save(out, os.path.join(work, f"sp_{fault or 'sound'}_{rank}.pt"))
    multihost.sync()
    torch.distributed.destroy_process_group()


def spb_worker(rank, port, work, fault=None):
    """One rank of phase 20 (d), run as `chip_smoke.py --spb-worker <rank>
    <port> <dir>`: the CSG and SG legs over four gloo ranks on the card
    (--mesh-sp 4), and K1's launches in them; with SPB_FAULT after <dir>,
    that fault planted, GeneratorCSG's first iteration only."""
    import torch

    from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1
    from hpvaegan_tpu_torch.parallel import mesh, multihost

    device = mesh.select_device(DP_DEVICE, 0)
    multihost.init_distributed(f"127.0.0.1:{port}", SPB_RANKS, rank,
                               backend="gloo", device=device)
    group = mesh.make_data_group(1, SPB_RANKS)
    out = {"backend": torch.distributed.get_backend(),
           "place": (group.sp.rank, group.sp.size)}
    k1.fused_upscale_noise_2d.launches = 0
    with exact_math(torch):
        if fault:
            plant_sp_fault(fault)
            out[SPB_GENS[0]] = sp_train_leg(torch, group, 3, True,
                                            SPB_GENS[0])
        else:
            for name in SPB_GENS:
                out[name] = sp_train_leg(torch, group, 3, generator=name)
    out["k1_launches"] = k1.fused_upscale_noise_2d.launches
    torch.save(out, os.path.join(work, f"spb_{fault or 'sound'}_{rank}.pt"))
    multihost.sync()
    torch.distributed.destroy_process_group()


def spatial_baselines(torch, k1):
    """Phase 20 (d) (module doc): the CSG/SG legs in this process, then
    on SPB_RANKS ranks, then the planted fault on as many."""
    from hpvaegan_tpu_torch.parallel import mesh

    t_start = time.perf_counter()
    k1.fused_upscale_noise_2d.launches = 0
    with exact_math(torch):
        one = {name: sp_train_leg(torch, mesh.DataGroup(), 3, generator=name)
               for name in SPB_GENS}
    one_launches = k1.fused_upscale_noise_2d.launches
    with tempfile.TemporaryDirectory(prefix="hpv_spb_") as work:
        t0 = time.perf_counter()
        ranks = join_ranks(torch, start_ranks(
            work, kind="spb", ranks=SPB_RANKS), work, kind="spb",
            ranks=SPB_RANKS)
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        faulty = join_ranks(torch, start_ranks(
            work, SPB_FAULT, kind="spb", ranks=SPB_RANKS), work, SPB_FAULT,
            kind="spb", ranks=SPB_RANKS)
        fault_s = time.perf_counter() - t0
    check([r["place"] for r in ranks] == [(s, SPB_RANKS)
                                          for s in range(SPB_RANKS)],
          f"spatial places {[r['place'] for r in ranks]}")
    launches = [one_launches] + [r["k1_launches"] for r in ranks]
    check(launches == [0] * (1 + SPB_RANKS),
          f"K1 launched {launches} times in the baselines' training")
    out = {}
    for name in SPB_GENS:
        legs = [r[name] for r in ranks]
        for part in ("G", "D"):
            same = all(torch.equal(v, leg[part][k]) for leg in legs[1:]
                       for k, v in legs[0][part].items())
            check(same, f"{name}: the ranks' {part} differ")
        check(all(leg["metrics"] == legs[0]["metrics"] for leg in legs),
              f"{name}: the ranks' metrics")
        rel = first_iteration_rel(legs[0], one[name])
        check(max(rel.values()) <= DP_TRAIN_REL,
              f"{name} spatial mesh of {SPB_RANKS} vs 1 process: {rel}")
        g_par, g_run = param_diffs(legs[0]["G"], one[name]["G"])
        # scale 9's 192 rows split into 48 a rank; the middle ranks' convs
        # run on 48 + 2, the edge ranks' on their pad rows too: the two
        # kinds of rank must differ, and the edge ranks mirror each other
        rows = [leg["conv_rows"] for leg in legs]
        check(48 + 2 in rows[1] and rows[1] == rows[2]
              and rows[0] == rows[3] and set(rows[0]) != set(rows[1]),
              f"{name}: the sharded convolutions' heights {rows}")
        check(not one[name]["conv_rows"],
              f"{name}: one process ran sharded convolutions")
        out[name] = {
            "ranks": SPB_RANKS, "mesh_sp": SPB_RANKS,
            "backend": ranks[0]["backend"], "batch": 1, "scale": DP_SCALE,
            "iterations": SP_ITERS[3], **rel,
            f"G_param_max_diff_after_{SP_ITERS[3]}": g_par,
            f"G_running_stats_max_rel_after_{SP_ITERS[3]}": g_run,
            f"steps_per_s_{SPB_RANKS}_ranks": legs[0]["steps_per_s"],
            "steps_per_s_1_process": one[name]["steps_per_s"],
            "exchange_ms_per_rank": [leg["exchange_ms"] for leg in legs],
            "collectives_per_iteration": legs[0]["collectives"],
            "peak_gb_per_rank": [leg["peak_gb"] for leg in legs],
            "peak_gb_1_process": one[name]["peak_gb"],
            "ranks_bit_equal": True,
            "conv_heights_edge_rank0_iter1": rows[0],
            "conv_heights_middle_rank1_iter1": rows[1],
            "k1_launches": launches}
        print(f"  (d) {name} vs WDiscriminatorBaselines, full-width scale "
              f"{DP_SCALE}, batch 1, {SPB_RANKS} gloo ranks splitting H "
              "into unequal padded shards vs 1 process (TF32 off): "
              + json.dumps(out[name]), flush=True)
    rels = [first_iteration_rel(r[SPB_GENS[0]], one[SPB_GENS[0]])
            for r in faulty]
    planted = {k: max(r[k] for r in rels) for k in rels[0]}
    check(max(planted.values()) > DP_TRAIN_REL,
          f"planted fault {SPB_FAULT} reads {planted}, within DP_TRAIN_REL "
          f"{DP_TRAIN_REL}")
    out["fault"] = planted
    print(f"  (d) planted fault {SPB_FAULT}, {SPB_GENS[0]} first iteration "
          f"on {SPB_RANKS} ranks vs 1 process (the largest rank's reading; "
          f"bar {DP_TRAIN_REL}): " + json.dumps(planted), flush=True)
    print(f"  (d) took {time.perf_counter() - t_start:.1f} s (the ranks' "
          f"processes {ranks_s:.1f} s, the fault's {fault_s:.1f} s)",
          flush=True)
    return out


def phase_spatial(torch, k1):
    """Phase 20 (module doc)."""
    from hpvaegan_tpu_torch.parallel import mesh

    k1.fused_upscale_noise_2d.launches = 0
    with exact_math(torch):
        one = {ndim: sp_train_leg(torch, mesh.DataGroup(), ndim)
               for ndim in (2, 3)}
    check(k1.fused_upscale_noise_2d.launches == 0,
          f"K1 launched {k1.fused_upscale_noise_2d.launches} times in "
          "training")
    with tempfile.TemporaryDirectory(prefix="hpv_sp_") as work:
        t0 = time.perf_counter()
        ranks = join_ranks(torch, start_ranks(work, kind="sp"), work,
                              kind="sp")
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        started = [(f, start_ranks(work, f, kind="sp"))
                   for f in SP_FAULTS]
        faults = {f: join_ranks(torch, procs, work, f, kind="sp")
                  for f, procs in started}
        faults_s = time.perf_counter() - t0
    check([r["place"] for r in ranks] == [(0, 2), (1, 2)],
          f"spatial places {[r['place'] for r in ranks]}")
    out = {}
    for ndim, what in ((2, "2d"), (3, "3d")):
        r0, r1 = (r[what] for r in ranks)
        for part in ("G", "D"):
            same = all(torch.equal(v, r1[part][k])
                       for k, v in r0[part].items())
            check(same, f"{what}: the ranks' {part} differ")
        check(r0["metrics"] == r1["metrics"], f"{what}: the ranks' metrics")
        rel = first_iteration_rel(r0, one[ndim])
        check(max(rel.values()) <= DP_TRAIN_REL,
              f"{what} spatial mesh vs 1 process: {rel}")
        g_par, g_run = param_diffs(r0["G"], one[ndim]["G"])
        # scale 9's height 192 splits into 96 rows a rank; every 3x3
        # convolution there ran on them and one halo row on each side
        rows = [r["conv_rows"] for r in (r0, r1)]
        check(all(96 + 2 in c for c in rows),
              f"{what}: the sharded convolutions' heights {rows}")
        check(not one[ndim]["conv_rows"],
              f"{what}: one process ran sharded convolutions")
        out[what] = {
            "ranks": DP_RANKS, "mesh_sp": DP_RANKS, "backend": ranks[0][
                "backend"], "batch": 1, "scale": DP_SCALE,
            "iterations": SP_ITERS[ndim], **rel,
            f"G_param_max_diff_after_{SP_ITERS[ndim]}": g_par,
            f"G_running_stats_max_rel_after_{SP_ITERS[ndim]}": g_run,
            "steps_per_s_2_ranks": round(r0["steps_per_s"], 3),
            "steps_per_s_1_process": round(one[ndim]["steps_per_s"], 3),
            "exchange_ms_rank0": round(r0["exchange_ms"], 4),
            "exchange_ms_rank1": round(r1["exchange_ms"], 4),
            "collectives_per_iteration": r0["collectives"],
            "peak_gb_per_rank": [round(r["peak_gb"], 3) for r in (r0, r1)],
            "peak_gb_1_process": round(one[ndim]["peak_gb"], 3),
            "conv_heights_rank0_iter1": r0["conv_rows"]}
        print(f"  (a/b) {what} full-width scale {DP_SCALE}, batch 1, "
              f"{DP_RANKS} gloo ranks splitting H vs 1 process (TF32 off): "
              + json.dumps(out[what]), flush=True)
    print(f"  the two ranks' processes took {ranks_s:.1f} s", flush=True)
    planted = {}
    for fault, outs in faults.items():
        rels = [first_iteration_rel(o["2d"], one[2]) for o in outs]
        planted[fault] = {k: max(r[k] for r in rels) for k in rels[0]}
        check(max(planted[fault].values()) > DP_TRAIN_REL,
              f"planted fault {fault} reads {planted[fault]}, within "
              f"DP_TRAIN_REL {DP_TRAIN_REL}")
    print(f"  (c) planted faults, 2D first iteration on {DP_RANKS} ranks vs "
          f"1 process (the larger rank's reading; bar {DP_TRAIN_REL}; the "
          f"three pairs side by side, {faults_s:.1f} s): "
          + json.dumps(planted), flush=True)
    out["faults"] = planted
    out["baselines"] = spatial_baselines(torch, k1)
    return out


def phase_vae_nb_3d(torch, k1, hpvaegan_videos_per_s):
    """GeneratorVAE_nb 3D at full width (module doc, phase 21): (a) card vs
    CPU, (b) the 64-clip sampler, (c) train_video then eval_video. K1's
    count is set to 0 before (b) and (c) and read after each."""
    import numpy as np

    from hpvaegan_tpu_torch.data.video import SingleVideoDataset
    from hpvaegan_tpu_torch.evaluation import eval_z_tail, generate_samples
    from hpvaegan_tpu_torch.parallel import sampling

    out = {}
    tiny = tiny_config(video_path=os.path.join(HERE, "data", "vids",
                                               "synthetic.avi"),
                       max_frames=5, sampling_rates=[2, 1], hflip=True,
                       batch_size=2, generator="GeneratorVAE_nb")
    SingleVideoDataset(tiny, "cpu")  # sets org_fps, ar, fps_lcm
    print("  (a) one tiny 3D GeneratorVAE_nb iteration", flush=True)
    out["steps"] = phase_step_parity(torch, tiny, ndim=3,
                                     generator="GeneratorVAE_nb")

    cfg, _ = video_config(generator="GeneratorVAE_nb")
    gen = load_port_generator(cfg, random_jax_checkpoint(cfg, SEED + 5,
                                                         ndim=3),
                              "cuda", ndim=3)
    check(type(gen).__module__.endswith("networks_3d")
          and type(gen).__name__ == "GeneratorVAE_nb", f"built {type(gen)}")
    shape = (BATCH,) + tuple(video_sizes(cfg)[-1]) + (3,)
    z_tail = eval_z_tail(cfg, 3)
    parts = sampling.sub_batches(BATCH, sampling.generator_elements(
        cfg, gen, 3, z_tail))
    generate_samples(cfg, gen, ndim=3, seed=SEED)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.fused_upscale_noise_2d.launches = 0
    secs = []
    for r in range(2):
        t0 = time.perf_counter()
        samples = generate_samples(cfg, gen, ndim=3, seed=SEED + 1 + r)
        secs.append(time.perf_counter() - t0)
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == 0, f"the 3D VAE_nb sampler launched K1 {launches} "
          "times")
    check(samples.shape == shape, f"samples {samples.shape}, want {shape}")
    check(bool(np.isfinite(samples).all())
          and float(np.abs(samples).max()) <= 1.0,
          f"samples in [{samples.min()}, {samples.max()}]")
    sec = sum(secs) / len(secs)
    out["sampler"] = {
        "z": [BATCH] + list(z_tail), "samples": list(shape),
        "sub_batches": [b - a for a, b in parts],
        "s": [round(t, 4) for t in secs],
        "videos_per_s": round(BATCH / sec, 3),
        "GeneratorHPVAEGAN_videos_per_s_phase8": hpvaegan_videos_per_s,
        "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
        "std": round(float(samples.std()), 4), "k1_launches": launches}
    print("  (b) 64-clip per-sample-BN sampler, main path: "
          + json.dumps(out["sampler"]), flush=True)
    del gen, samples
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="hpv_nb3d_") as run:
        k1.fused_upscale_noise_2d.launches = 0
        out["train"] = phase_video_train_cli(torch, k1, run, "--generator",
                                             "GeneratorVAE_nb")
        with open(os.path.join(out["train"]["exp"], "args.txt")) as f:
            check("generator: GeneratorVAE_nb" in f.read().splitlines(),
                  "args.txt does not name GeneratorVAE_nb")
        out["train"]["k1_launches"] = k1.fused_upscale_noise_2d.launches
    check(out["train"]["k1_launches"] == 0, "VAE_nb 3D training or eval "
          f"launched K1 {out['train']['k1_launches']} times")
    out["k1_launches"] = launches + out["train"]["k1_launches"]
    return out


def module_state(torch, st):
    """Every tensor of a training state by name: G's and D's parameters and
    buffers, both optimizers' states and the NoiseSource's generators."""
    out = {}
    for part in ("G", "D"):
        for k, v in getattr(st, part).state_dict().items():
            out[f"{part}.{k}"] = v
    for part in ("opt_g", "opt_d"):
        for i, s in getattr(st, part).state_dict()["state"].items():
            for k, v in s.items():
                out[f"{part}.{i}.{k}"] = v
    for k, v in st.noise.get_state().items():
        out[f"noise.{k}"] = v
    return out


def state_diff(torch, a, b):
    """(max |a - b| over every tensor of two module_state dicts, whether
    all are equal bit for bit, the first name that differs)."""
    check(sorted(a) == sorted(b), f"state keys {sorted(a)} vs {sorted(b)}")
    worst, first = 0.0, None
    for k in sorted(a):
        x, y = a[k], b[k]
        if torch.equal(x.cpu(), y.cpu()):
            continue
        first = first or k
        if x.is_floating_point():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
        else:
            worst = float("inf")
    return worst, first is None, first


@contextlib.contextmanager
def profiled(torch):
    """A profiler window of the card's activity alone over the body: the
    idle share needs the kernels' spans, and without the host's operators
    a window of thousands of kernels is read in a fraction of the time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


def idle_share(torch, prof, wall_s):
    """(device busy ms, idle share) of a profiled window of `wall_s` host
    seconds; (None, None) where the profiler saw no device time (which a
    CUDA graph's kernels may not show)."""
    from torch.autograd import DeviceType

    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    if busy <= 0:
        return None, None
    return round(busy, 3), round(1 - busy / (wall_s * 1e3), 4)


# what CUDA's sync debug mode warns of a synchronizing operation
SYNC_WARNING = "called a synchronizing CUDA operation"
# the other warnings seen in captures, for the record
CAPTURE_WARNINGS = set()


@contextlib.contextmanager
def syncs_in_capture(torch, counts):
    """Within the body, every training iteration issued while a CUDA graph
    captures runs in CUDA's sync debug mode: `counts` gets the number of
    host synchronisations PyTorch warns of in each (0: the capture reads
    nothing back); any other warning's text goes to CAPTURE_WARNINGS."""
    import warnings

    from hpvaegan_tpu_torch.training import chunk as tchunk

    inner = tchunk.train_iteration

    def counted(*a, **kw):
        if not torch.cuda.is_current_stream_capturing():
            return inner(*a, **kw)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return inner(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                texts = [str(w.message) for w in seen]
                counts.append(sum(SYNC_WARNING in t for t in texts))
                CAPTURE_WARNINGS.update(t[:300] for t in texts
                                        if SYNC_WARNING not in t)

    tchunk.train_iteration = counted
    try:
        yield counts
    finally:
        tchunk.train_iteration = inner


def graph_vs_eager(torch, name, cfg, data, scale_idx, ndim,
                   generator="GeneratorHPVAEGAN", discriminator="",
                   want_mode="graph"):
    """Phase 22 (a), one case: 16 iterations as --steps-per-call 8 (the
    first chunk eager on the capture stream, then 8 replays of the
    captured iteration) against 16 --split-step eager iterations, from the
    same weights and seed, TF32 off and deterministic cuDNN. The first 8
    iterations are the same eager code in both runs: they run once, and
    the eager run starts from a copy of their end state. Steps/s over the
    last 7 iterations of each mode (after the capture and one replay, and
    one eager iteration), the idle share of each mode over 4 more
    profiled iterations (1 where an iteration takes over half a second),
    capture seconds, the graph pool's GB and the peak GB. In a group
    (`want_mode` "graph (N NCCL ranks)", the group in force) also the
    collectives the capture issued beside one eager iteration's and the
    host syncs in the capture, and the two runs must be equal bit for
    bit."""
    from hpvaegan_tpu_torch.parallel import mesh
    import copy

    from hpvaegan_tpu_torch import models
    from hpvaegan_tpu_torch.tools.step_parity import build_state
    from hpvaegan_tpu_torch.training import chunk as tchunk
    from hpvaegan_tpu_torch.training.steps import batch_former
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    vae = cfg.vae_levels >= scale_idx + 1
    amps = [1.0] + [0.05] * (cfg.stop_scale + 1)
    former = batch_former(ndim, scale_idx,
                          baseline=generator in models.BASELINES)

    def make(split):
        c = dataclasses.replace(cfg, niter=16, steps_per_call=8,
                                split_step=split, scale_idx=scale_idx)
        st = build_state(c, scale_idx, SEED, "cuda", ndim, generator,
                         discriminator)
        st.noise = NoiseSource(SEED, "cuda")
        return st, tchunk.TrainChunk(c, st, data, amps, vae, former)

    out = {"scale": scale_idx, "phase": "vae" if vae else "gan"}
    t_case = time.perf_counter()
    with exact_math(torch):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        graph_st, graph = make(False)
        check(graph.mode == want_mode, f"{name}: chunk mode {graph.mode}")
        t0 = time.perf_counter()
        graph.run(8)  # the first chunk: eager, on the capture stream
        torch.cuda.synchronize()
        slow = (time.perf_counter() - t0) / 8 > 0.5
        eager_st, eager = make(True)
        check(eager.mode == "eager (split-step)", f"{name}: {eager.mode}")
        eager_st.G.load_state_dict(graph_st.G.state_dict())
        eager_st.D.load_state_dict(graph_st.D.state_dict())
        for part in ("opt_g", "opt_d"):
            getattr(eager_st, part).load_state_dict(
                copy.deepcopy(getattr(graph_st, part).state_dict()))
        eager_st.noise.set_state(graph_st.noise.get_state())

        eager.run(1)
        torch.cuda.synchronize()
        calls = collective_calls(mesh)
        t0 = time.perf_counter()
        for _ in range(7):
            metrics_e = eager.run(1)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        eager_calls = (collective_calls(mesh) - calls) / 7
        replays, calls, syncs = tchunk.replays, collective_calls(mesh), []
        with syncs_in_capture(torch, syncs):
            graph.run(1)  # the capture, then one replay
        torch.cuda.synchronize()
        captured_calls = collective_calls(mesh) - calls
        t0 = time.perf_counter()
        metrics_g = graph.run(7)
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        check(tchunk.replays - replays == 8, f"{name}: replays")
        diff, equal, first = state_diff(torch, module_state(torch, graph_st),
                                        module_state(torch, eager_st))
        mdiff = max(abs(float(metrics_g[k]) - float(metrics_e[k]))
                    for k in metrics_e)
        check(diff <= 1e-4 and mdiff <= 1e-4, f"{name}: graph vs eager "
              f"state {diff} (first {first}), metrics {mdiff}")
        check(want_mode == "graph" or (equal and mdiff == 0),
              f"{name}: graph vs eager in the group: state {diff} (first "
              f"{first}), metrics {mdiff}; bit for bit expected")
        check(syncs == [0] and captured_calls == eager_calls,
              f"{name}: host syncs in the capture {syncs}, collectives "
              f"captured {captured_calls} vs {eager_calls} an eager "
              f"iteration; other warnings {sorted(CAPTURE_WARNINGS)}")
        check(all(math.isfinite(float(v)) for v in metrics_g.values()),
              f"{name}: metrics {metrics_g}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        idle, reps = {}, 1 if slow else 4
        for mode, chunk in (("eager", eager), ("graph", graph)):
            with profiled(torch) as prof:
                t0 = time.perf_counter()
                if mode == "graph":
                    chunk.run(reps)
                else:
                    for _ in range(reps):
                        chunk.run(1)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            idle[mode] = idle_share(torch, prof, secs)
        graph.close()
    out.update({
        "bit_equal": equal, "max_abs_diff": diff, "metrics_max_abs_diff":
        mdiff, "first_differing": first,
        "eager_steps_per_s": round(7 / eager_s, 3),
        "graph_steps_per_s": round(7 / graph_s, 3),
        "eager_idle_share": idle["eager"][1],
        "graph_idle_share": idle["graph"][1],
        "eager_busy_ms": idle["eager"][0], "graph_busy_ms": idle["graph"][0],
        "idle_window_iterations": reps,
        "capture_s": round(graph.capture_s, 3),
        "graph_pool_gb": round(graph.pool_bytes / 1e9, 3),
        "mode": want_mode, "collectives_captured": captured_calls,
        "collectives_per_eager_iteration": eager_calls,
        "host_syncs_in_capture": syncs[0],
        "peak_gb": round(peak_gb, 3),
        "case_s": round(time.perf_counter() - t_case, 1)})
    print(f"  (a) {name}, scale {scale_idx}: " + json.dumps(out), flush=True)
    return out


def chunked_main_path(torch, k1, run):
    """Phase 22 (b): train_image at full width, 10 scales x 16 iterations,
    --steps-per-call 8 --ckpt-interval 8 --print-interval 4, TF32 off and
    deterministic cuDNN: one capture a scale, the JAX trainer's logbook
    iterations. A second run, resumed from the first run's finalized
    marker of scale 8 (netG_8, netD_8, torch_rng_8.pt and
    intermediate.json as they stood when scale 8 ended: exact, phase 13),
    is killed after the first chunk of scale 9 and resumed from its
    inflight_9.ckpt (netG_9 against the uninterrupted run's); a resume
    with a --steps-per-call that does not divide the inflight iteration is
    refused."""
    from hpvaegan_tpu_torch import train_image
    from hpvaegan_tpu_torch.training import chunk as tchunk
    from hpvaegan_tpu_torch.training import trainer
    from hpvaegan_tpu_torch.utils.saver import DataSaver

    flags = ("--niter", "16", "--steps-per-call", "8", "--ckpt-interval", "8",
             "--print-interval", "4")
    scale8 = os.path.join(run, "scale8")
    finalize = DataSaver.finalize_scale

    def keep_scale8(self, scale_idx, *a, **kw):
        finalize(self, scale_idx, *a, **kw)
        if scale_idx == 8:
            os.makedirs(scale8)
            for name in ("netG_8.ckpt", "netD_8.ckpt", "torch_rng_8.pt",
                         "intermediate.json"):
                shutil.copy(os.path.join(self.experiment_dir, name), scale8)

    k1.fused_upscale_noise_2d.launches = 0
    tchunk.captures = tchunk.replays = 0
    DataSaver.finalize_scale = keep_scale8
    try:
        with exact_math(torch):
            exp, train_s, scale_s = timed_scales(
                trainer, train_image.main,
                image_train_args(os.path.join(run, "ref"), *flags,
                                 graph=True))
    finally:
        DataSaver.finalize_scale = finalize
    captures, replays = tchunk.captures, tchunk.replays
    check(captures == 10 and replays == 80,
          f"captures {captures}, replays {replays}: want 10 and 80")
    with open(os.path.join(exp, "logbook.txt")) as f:
        logged = [ln.split("[Scale ", 1)[1].split("]", 1)[0]
                  for ln in f.read().splitlines() if "[Scale " in ln]
    # the JAX trainer logs where done % print_interval < steps_per_call:
    # at done 8 and 16 of every scale
    want = [f"{s}/Iter {i}" for s in range(1, 11) for i in (8, 16)]
    check(logged == want, f"logbook iterations {logged}, want {want}")

    t0 = time.perf_counter()
    with exact_math(torch):
        killed = killed_run(trainer, train_image.main, image_train_args(
            os.path.join(run, "kill"), *flags, "--netG",
            os.path.join(scale8, "netG_8.ckpt"), "--intermediate",
            os.path.join(scale8, "intermediate.json"), graph=True), 9, 8)
    kill_s = time.perf_counter() - t0
    with open(os.path.join(killed, "intermediate.json")) as f:
        inter = json.load(f)
    check(inter.get("inflight") == "inflight_9.ckpt"
          and inter["inflight_iter"] == 8, f"killed marker {inter}")
    resume = ["--netG", os.path.join(killed, "inflight_9.ckpt"),
              "--intermediate", os.path.join(killed, "intermediate.json")]
    try:
        train_image.main(image_train_args(
            os.path.join(run, "misaligned"), *flags, "--steps-per-call", "3",
            *resume, graph=True))
        fail("a resume at --steps-per-call 3 from iteration 8 ran")
    except ValueError as e:
        refused = str(e)
    check("inflight iteration 8 is not a multiple of steps_per_call=3"
          in refused, f"misaligned resume: {refused}")
    tchunk.captures = tchunk.replays = 0
    diff, tail_s = resume_and_compare(
        torch, train_image.main, exp,
        image_train_args(os.path.join(run, "resumed"), *flags,
                         "--manualSeed", "7", graph=True),
        killed, "inflight_9.ckpt")
    out = {"train_s": round(train_s, 2), "scale_s": scale_s,
           "captures": captures, "replays": replays,
           "logbook_iterations_per_scale": [8, 16],
           "killed_run_s": round(kill_s, 2),
           "resumed_netG_9_max_abs_diff": diff, "bit_equal": diff == 0,
           "resumed_tail_s": round(tail_s, 2),
           "resumed_captures": tchunk.captures,
           "resumed_replays": tchunk.replays,
           "misaligned_resume_refused": refused,
           "k1_launches": k1.fused_upscale_noise_2d.launches}
    print("  (b) train_image --niter 16 --steps-per-call 8 --ckpt-interval 8 "
          "--print-interval 4; resumed from its scale-8 marker, killed "
          "after the first chunk of scale 9 and resumed: " + json.dumps(out),
          flush=True)
    return out


def chunk_scale9_video(torch):
    """Phase 22 (a)'s device-bound cases: the 3D GeneratorHPVAEGAN and
    GeneratorCSG at scale 9 (13x192x257). The full script runs them while
    phase 18's export CLIs compile, when the main process would only wait:
    the card is otherwise idle then, and these iterations keep it busy,
    so the compiles' load on the host barely sets their rate (on an H100
    the eager 3D iterations ran up to 7% slower beside them, the graph
    replays not)."""
    vcfg, vdata = video_config()
    data = vdata.scale_frames(9), vdata.scale_frames(0)
    out = {"3d_9": graph_vs_eager(torch, "3D GeneratorHPVAEGAN", vcfg, data,
                                  9, 3)}
    out["csg_9"] = graph_vs_eager(
        torch, "GeneratorCSG", dataclasses.replace(
            vcfg, generator="GeneratorCSG",
            discriminator="WDiscriminatorBaselines"), data, 9, 3,
        "GeneratorCSG", "WDiscriminatorBaselines")
    return out


def phase_chunk(torch, k1, scale9_video=None):
    """Phase 22 (module doc); `scale9_video`: chunk_scale9_video's result
    where it already ran (beside phase 18), else it runs here."""
    from hpvaegan_tpu_torch.data.image import SingleImageDataset

    out = {}
    image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
    cfg = full_width_config(image_path=image, batch_size=1)
    dataset = SingleImageDataset(cfg, "cuda")
    for scale_idx in (2, 9):
        out[f"2d_{scale_idx}"] = graph_vs_eager(
            torch, "2D GeneratorHPVAEGAN", cfg,
            (dataset.scale_image(scale_idx), dataset.scale_image(0)),
            scale_idx, 2)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16", fused_dg=True,
                               flat_opt=True)
    out["2d_bf16_fused_flat_9"] = graph_vs_eager(
        torch, "2D bf16 --fused-dg --flat-opt", bf16,
        (dataset.scale_image(9), dataset.scale_image(0)), 9, 2)
    vcfg, vdata = video_config()
    out["3d_2"] = graph_vs_eager(
        torch, "3D GeneratorHPVAEGAN", video_at(vcfg, 2),
        (vdata.scale_frames(2), vdata.scale_frames(0)), 2, 3)
    del dataset, vdata
    out.update(scale9_video or chunk_scale9_video(torch))
    with tempfile.TemporaryDirectory(prefix="hpv_chunk_") as run:
        out["main"] = chunked_main_path(torch, k1, run)
    return out


# --cards 4: the mesh as it is deployed, four NCCL ranks of one card each
# (`chip_smoke.py --cards-worker` processes; the default run never starts
# them), against this process on card 0 at the same global batch, TF32 off
CARDS = 4
# (--mesh-data D, --mesh-sp S) of cases (a) and (b); the global batch is D
CARD_MESHES = ((4, 1), (1, 4), (2, 2))
# iterations a chunk (--steps-per-call) and profiled iterations a mode
CARD_ITERS = {2: 8, 3: 2}
CARD_PROFILE = {2: 4, 3: 1}
# (f): the faults planted in graph mode, each on the mesh whose
# collectives it breaks
CARD_FAULTS = (("grads_not_averaged", (4, 1)), ("bn_not_reduced", (4, 1)),
               ("halo_wrong_neighbour", (1, 4)))
# (d): the fault planted in every rank of a train CLI's mesh run
CLI_FAULT = "grads_not_averaged"


def restore_state(torch, st, src):
    """Set `st`'s G, D, optimizer states and draws to `src`'s in place (the
    tensors a captured graph reads keep their addresses), `src` being a
    state that has run no iteration: its optimizers hold no state, which a
    zeroed step and zeroed moments are."""
    st.G.load_state_dict(src.G.state_dict())
    st.D.load_state_dict(src.D.state_dict())
    for opt in (st.opt_g, st.opt_d):
        for state in opt.state.values():
            for v in state.values():
                if torch.is_tensor(v):
                    v.zero_()
    st.noise.set_state(src.noise.get_state())


def nccl_share(torch, fn):
    """fn()'s wall ms and the device ms of its kernels, of NCCL's among
    them, from one profiler window: the share of an iteration in NCCL's
    kernels (their time includes their wait for the other ranks)."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with profiled(torch) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    nccl_ms = sum(e.time_range.elapsed_us() for e in nccl) / 1e3
    return {"wall_ms": round(wall_ms, 3), "busy_ms": round(busy, 3),
            "nccl_ms": round(nccl_ms, 3), "nccl_kernels": len(nccl),
            "nccl_share": round(nccl_ms / wall_ms, 4) if busy else None}


def card_leg(torch, group, ndim, batch, generator=None, graph=True,
             first_only=False):
    """One training case of --cards: the full-width scale-9 iteration of
    the 2D (192x257) or 3D (13x192x257) GeneratorHPVAEGAN, or of the
    baseline `generator` against WDiscriminatorBaselines, at global batch
    `batch` under `group` (a rank's share, or the whole in one process),
    in chunks of CARD_ITERS[ndim]. The first chunk runs iteration 1
    eagerly on the capture stream: its metrics and gradients are what
    DP_TRAIN_REL holds to one process. With `graph` the state is then set
    back to its start in place and the next chunk captures iteration 1
    and replays it: the graph's metrics and gradients must equal the
    eager ones bit for bit (a planted fault's reading is the graph's). Then
    the graph's other iterations against as many --split-step iterations
    of a second state built alike (which supplied the start), bit for bit
    at the end; steps/s of each mode, the collectives captured beside an
    eager iteration's, host syncs in the capture, the share of each mode
    in NCCL's kernels, peak GB, the heights the H-sharded convolutions ran
    on, capture s and the graph pool's GB."""
    from hpvaegan_tpu_torch.data.image import SingleImageDataset
    from hpvaegan_tpu_torch.parallel import mesh, spatial
    from hpvaegan_tpu_torch.tools.step_parity import build_state
    from hpvaegan_tpu_torch.training import chunk as tchunk
    from hpvaegan_tpu_torch.training.steps import batch_former
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    k = CARD_ITERS[ndim]
    if ndim == 2:
        image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
        cfg = full_width_config(image_path=image, batch_size=batch)
        dataset = SingleImageDataset(cfg, DP_DEVICE)
        data = dataset.scale_image(DP_SCALE), dataset.scale_image(0)
    else:
        cfg, dataset = video_config(batch_size=batch)
        data = dataset.scale_frames(DP_SCALE), dataset.scale_frames(0)
    models = ("GeneratorHPVAEGAN", "")
    if generator:
        models = (generator, "WDiscriminatorBaselines")
        cfg = dataclasses.replace(cfg, generator=generator,
                                  discriminator=models[1])
    cfg = dataclasses.replace(cfg, niter=k, steps_per_call=k,
                              scale_idx=DP_SCALE)
    amps = [1.0] + [0.05] * (cfg.stop_scale + 1)
    former = batch_former(ndim, DP_SCALE, baseline=bool(generator))

    def make(split):
        c = dataclasses.replace(cfg, split_step=split)
        st = build_state(c, DP_SCALE, SEED, DP_DEVICE, ndim, *models)
        st.noise = NoiseSource(SEED, DP_DEVICE)
        return st, tchunk.TrainChunk(c, st, data, amps, False, former)

    def grads(module):
        return {n: p.grad.detach().cpu().clone()
                for n, p in module.named_parameters() if p.grad is not None}

    def reading(st, metrics):
        return {"metrics": {n: float(v) for n, v in metrics.items()},
                "G_grads": grads(st.G), "D_grads": grads(st.D)}

    out = {"batch": batch, "iterations": k}
    with mesh.data_parallel(group):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st, chunk = make(not graph)
        ref_st, eager = make(True) if graph else (st, chunk)
        out["mode"] = chunk.mode
        spatial.conv_rows.clear()
        out["first"] = reading(st, chunk.run(1))
        out["conv_rows"] = dict(sorted(spatial.conv_rows.items()))
        if graph:
            torch.cuda.synchronize()
            restore_state(torch, st, ref_st)
            calls, syncs = collective_calls(mesh), []
            with syncs_in_capture(torch, syncs):
                metrics = chunk.run(1)  # the capture, then one replay
            torch.cuda.synchronize()
            out["collectives_captured"] = collective_calls(mesh) - calls
            out["host_syncs_in_capture"] = syncs
            out["graph_first"] = reading(st, metrics)
            out["capture_s"] = round(chunk.capture_s, 3)
            out["graph_pool_gb"] = round(chunk.pool_bytes / 1e9, 3)
            out["graph_first_bit_equal"] = out["graph_first"]["metrics"] \
                == out["first"]["metrics"] and all(
                    torch.equal(v, out["first"][part][n])
                    for part in ("G_grads", "D_grads")
                    for n, v in out["graph_first"][part].items())
        if not first_only:
            if graph:
                eager.run(1)  # iteration 1 of the state that stayed eager
            torch.cuda.synchronize()
            calls = collective_calls(mesh)
            t0 = time.perf_counter()
            for _ in range(k - 1):
                metrics_e = eager.run(1)
            torch.cuda.synchronize()
            out["eager_steps_per_s"] = (k - 1) / (time.perf_counter() - t0)
            out["collectives_per_eager_iteration"] = (
                collective_calls(mesh) - calls) / (k - 1)
            check(all(math.isfinite(float(v)) for v in metrics_e.values()),
                  f"metrics {metrics_e}")
            if graph:
                t0 = time.perf_counter()
                chunk.run(k - 1)
                torch.cuda.synchronize()
                out["graph_steps_per_s"] = (k - 1) / (time.perf_counter()
                                                      - t0)
                diff, equal, first = state_diff(
                    torch, module_state(torch, st),
                    module_state(torch, ref_st))
                out.update(graph_vs_eager_max_diff=diff,
                           graph_vs_eager_bit_equal=equal,
                           graph_vs_eager_first_differing=first)
            reps = CARD_PROFILE[ndim]
            out["nccl_share_eager"] = nccl_share(
                torch, lambda: [eager.run(1) for _ in range(reps)])
            if graph:
                out["nccl_share_graph"] = nccl_share(
                    torch, lambda: chunk.run(reps))
            out["G"] = {n: v.cpu() for n, v in st.G.state_dict().items()}
            out["D"] = {n: v.cpu() for n, v in st.D.state_dict().items()}
        out["peak_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
        chunk.close()
    del st, ref_st, chunk, eager, data, dataset
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def planted(fault):
    """One fault of CARD_FAULTS planted for the extent of the body (the
    module attributes it replaces put back after): phase 19 (c)'s
    gradients not averaged and BatchNorm not reduced over the data axis,
    or each halo taken from the wrong neighbour (the rank above's rows
    where the rank below's belong, and the other way round)."""
    from hpvaegan_tpu_torch.ops import norm
    from hpvaegan_tpu_torch.parallel import spatial
    from hpvaegan_tpu_torch.training import steps

    saved = [(steps, "_set_grads", steps._set_grads),
             (norm, "set_group_sum", norm.set_group_sum),
             (spatial, "_neighbour_rows", spatial._neighbour_rows)]
    if fault == "halo_wrong_neighbour":
        inner = spatial._neighbour_rows

        def swapped(top, bottom, ax):
            above, below = inner(bottom, top, ax)
            return below, above
        spatial._neighbour_rows = swapped
    else:
        plant_fault(fault)
    try:
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)


def card_eval_leg(torch, exp, ndim, mesh_data):
    """--on-device-fid SIFID (2D) or SVFID (3D) of DP_SAMPLES samples on
    `exp` over --mesh-data ranks, or one process (1)."""
    if ndim == 2:
        return dp_eval_leg(torch, exp, mesh_data)
    from hpvaegan_tpu_torch.evaluation import (eval_video_experiment,
                                               hydrate_config)

    cfg = hydrate_config(exp, dict(
        niter=1, data_rep=1, batch_size=1, num_samples=DP_SAMPLES,
        max_samples=4, save_path="images", scale_idx=-1,
        mesh_data=mesh_data, on_device_fid=True, netG=""))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = eval_video_experiment(cfg, exp, seed=SEED, device=DP_DEVICE)[0]
    return {"SVFID": value, "s": time.perf_counter() - t0}


def cards_worker(rank, port, work):
    """One rank of --cards, run as `chip_smoke.py --cards-worker <rank>
    <port> <dir>`: card `rank` (select_device's rule for the explicit
    bootstrap), NCCL, and in one process group the training cases (a)-(c),
    the evaluation (e) and the planted faults (f)."""
    import torch
    import torch.distributed as dist

    from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1
    from hpvaegan_tpu_torch.parallel import mesh, multihost

    device = mesh.select_device(DP_DEVICE, 0, rank)
    multihost.init_distributed(f"127.0.0.1:{port}", CARDS, rank,
                               device=device)
    # every rank makes every group, in this order
    groups = {m: mesh.make_data_group(*m) for m in CARD_MESHES}
    out = {"backend": dist.get_backend(), "device": str(device),
           "card": torch.cuda.get_device_name(device), "s": {}}

    def timed(key, fn):
        t0 = time.perf_counter()
        out[key] = fn()
        out["s"][str(key)] = round(time.perf_counter() - t0, 1)
        print(f"rank {rank}: {key} in {out['s'][str(key)]} s", flush=True)

    with exact_math(torch):
        for ndim in (2, 3):
            for m in CARD_MESHES:
                timed((ndim,) + m, lambda: card_leg(torch, groups[m], ndim,
                                                    m[0]))
        timed("csg", lambda: card_leg(torch, groups[(1, CARDS)], 3, 1,
                                      "GeneratorCSG"))
        timed("eval_image", lambda: card_eval_leg(
            torch, os.path.join(work, "image"), 2, CARDS))
        timed("eval_video", lambda: card_eval_leg(
            torch, os.path.join(work, "video"), 3, CARDS))
        timed("sampler", lambda: dp_sampler_leg(
            torch, k1, os.path.join(work, "image"), groups[(CARDS, 1)]))
        for fault, m in CARD_FAULTS:
            with planted(fault):
                timed(fault, lambda: card_leg(
                    torch, mesh.make_data_group(*m), 2, m[0],
                    first_only=True))
    torch.save(out, os.path.join(work, f"cards_sound_{rank}.pt"))
    multihost.sync()
    dist.destroy_process_group()


def cards_cli(kind, variant, run, *dist_flags):
    """One rank of a --cards (d) mesh run, as `chip_smoke.py --cards-cli
    <kind> <variant> <run dir> [--dist-* flags]` (torchrun's environment
    without them): `cli_variant` on the mesh of `kind`."""
    import torch.distributed as dist

    flags = list(dist_flags) or ["--dist-coordinator", "auto"]
    flags += (["--mesh-data", "2", "--mesh-sp", "2"] if kind == "image"
              else ["--mesh-sp", str(CARDS)])
    cli_variant(kind, variant, run, flags)
    dist.destroy_process_group()


def cli_variant(kind, variant, run, flags):
    """--cards (d)'s train CLI of `kind` in this process, TF32 off and
    deterministic cuDNN, as `variant`: "one" and "graph" as they are,
    "split" under --split-step, "ulp" with every training input one ulp up
    (`ulp_inputs`), "fault" with CLI_FAULT planted. Each scale's G and D as
    this rank holds them at the scale's end go to <run>/states_<rank>.pt
    (`scale_states`)."""
    import torch
    import torch.distributed as dist

    extra = ["--split-step"] if variant == "split" else []
    variation = {"ulp": lambda: ulp_inputs(torch),
                 "fault": lambda: planted(CLI_FAULT)}.get(
                     variant, contextlib.nullcontext)
    with exact_math(torch), variation(), scale_states(torch) as states:
        card_train_cli(kind, run, flags + extra)
    rank = dist.get_rank() if dist.is_initialized() else 0
    torch.save(states, os.path.join(run, f"states_{rank}.pt"))


def card_train_cli(kind, run, flags):
    """--cards (d)'s train CLI, in this process: train_image 10 scales x 16
    iterations at --steps-per-call 8, global batch 2; or
    train_video_baselines (GeneratorCSG) 10 scales x 4 iterations at
    --steps-per-call 2, batch 1."""
    if kind == "image":
        from hpvaegan_tpu_torch import train_image

        return train_image.main(image_train_args(
            run, "--niter", "16", "--steps-per-call", "8",
            "--print-interval", "8", "--batch-size", "2", *flags,
            graph=True))
    from hpvaegan_tpu_torch import train_video_baselines

    return train_video_baselines.main([
        "--video-path", os.path.join(HERE, "data", "vids",
                                     "balloons_pan.avi"),
        "--max-frames", "13", "--sampling-rates", "4", "3", "2", "1",
        "--niter", "4", "--steps-per-call", "2", "--print-interval", "2",
        "--batch-size", "1", "--run-dir", run, "--checkname", "smoke",
        "--manualSeed", "1", *flags])


@contextlib.contextmanager
def scale_states(torch):
    """Yields {scale: {"G" | "D": {"params" | "buffers": {name: SHA-1 of
    the tensor's bytes}}}}, filled as each scale ends (its chunk's
    `close`): what this rank holds then, weights apart from BatchNorm's
    running statistics and the other buffers."""
    import hashlib

    from hpvaegan_tpu_torch.training import chunk as tchunk

    close, states = tchunk.TrainChunk.close, {}

    def digest(v):
        v = v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        return hashlib.sha1(v.numpy().tobytes()).hexdigest()

    def hashed(self):
        states[self.cfg.scale_idx] = {
            part: {"params": {n: digest(v)
                              for n, v in module.named_parameters()},
                   "buffers": {n: digest(v)
                               for n, v in module.named_buffers()}}
            for part, module in (("G", self.st.G), ("D", self.st.D))}
        close(self)

    tchunk.TrainChunk.close = hashed
    try:
        yield states
    finally:
        tchunk.TrainChunk.close = close


@contextlib.contextmanager
def ulp_inputs(torch):
    """Every element of the training image or frames, at every scale, one
    ulp up (`torch.nextafter` towards +inf): a perturbation of the size of
    the rounding that a different order of float32 sums makes."""
    from hpvaegan_tpu_torch.data.image import SingleImageDataset
    from hpvaegan_tpu_torch.data.video import SingleVideoDataset

    saved = [(cls, name, getattr(cls, name))
             for cls, name in ((SingleImageDataset, "scale_image"),
                               (SingleVideoDataset, "scale_frames"))]
    for cls, name, method in saved:
        def up(self, scale_idx, method=method):
            x = method(self, scale_idx)
            return torch.nextafter(x, torch.full_like(x, math.inf))
        setattr(cls, name, up)
    try:
        yield
    finally:
        for cls, name, method in saved:
            setattr(cls, name, method)


def experiment_of(run):
    """The one experiment dir a train CLI run wrote under `run`."""
    import glob

    exps = glob.glob(os.path.join(run, "**", "experiment_*"),
                     recursive=True)
    check(len(exps) == 1, f"{run}: experiment dirs {exps}")
    return exps[0]


def logged_modes(exp):
    """The chunk mode each scale's line of the logbook names."""
    import re

    with open(os.path.join(exp, "logbook.txt")) as f:
        return re.findall(r"scale \d+: chunks of \d+ iterations, (.*)",
                          f.read())


def ckpt_diffs(a, b):
    """`param_diffs`' readings of two netG checkpoints in the JAX layout:
    (max |diff| over the weights, "params", max relative |diff| over
    "state", BatchNorm's running statistics)."""
    import numpy as np

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for t in tree for x in leaves(t)]
        return [np.asarray(tree, dtype=np.float64)]

    par = [float(np.abs(x - y).max())
           for x, y in zip(leaves(a["params"]), leaves(b["params"]))]
    run = [float((np.abs(x - y) / np.maximum(np.abs(y), 1e-3)).max())
           for x, y in zip(leaves(a["state"]), leaves(b["state"]))]
    return max(par), max(run, default=0.0)


def ranks_differ(states):
    """{scale: {"params": n, "buffers": n}}: the tensors of G and D in
    which the ranks' `scale_states` differ, at the scales where any do."""
    out = {}
    for k in sorted(states[0]):
        n = {kind: sum(len({r[k][part][kind][name] for r in states}) > 1
                       for part in ("G", "D")
                       for name in states[0][k][part][kind])
             for kind in ("params", "buffers")}
        if any(n.values()):
            out[k] = n
    return out


def read_cli_run(torch, run):
    """A --cards (d) run's experiment: its chunk modes, amps, every
    scale's netG and each rank's `scale_states`."""
    import glob

    from hpvaegan_tpu_torch.utils.saver import load_pytree

    exp = experiment_of(run)
    with open(os.path.join(exp, "intermediate.json")) as f:
        amps = json.load(f)["noise_amps"]
    return {"modes": logged_modes(exp), "amps": amps,
            "netG": [load_pytree(os.path.join(exp, f"netG_{k}.ckpt"))
                     for k in range(len(amps))],
            "states": [torch.load(path) for path in sorted(
                glob.glob(os.path.join(run, "states_*.pt")))]}


def mesh_cli(kind, variant, run):
    """Start --cards (d)'s mesh run of `kind`: train_image --mesh-data 2
    --mesh-sp 2 under torchrun (--dist-coordinator auto), or
    train_video_baselines --mesh-sp 4 with explicit --dist-* flags and no
    --device-id (each rank takes its card by its process id); wait for it
    (join_in_group)."""
    script = os.path.abspath(__file__)
    os.makedirs(run)
    if kind == "image":
        logs = [os.path.join(run, "torchrun.log")]
        procs = [start_in_group(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(CARDS), script, "--cards-cli", kind,
             variant, run], logs[0])]
    else:
        port = free_port()
        logs = [os.path.join(run, f"rank_{r}.log") for r in range(CARDS)]
        procs = [start_in_group(
            [sys.executable, script, "--cards-cli", kind, variant, run,
             "--dist-coordinator", f"127.0.0.1:{port}", "--dist-nprocs",
             str(CARDS), "--dist-procid", str(r)], logs[r])
            for r in range(CARDS)]
    join_in_group(procs, logs, f"--cards (d) {kind} {variant}")


def card_clis(torch, work):
    """--cards (d): each train CLI (`card_train_cli`) five ways: one
    process on card 0 ("one"), the same with its inputs one ulp up
    ("ulp"), and on its mesh of four NCCL ranks (`mesh_cli`) as it is
    ("graph"), under --split-step ("split") and, train_image only, with
    CLI_FAULT planted in every rank ("fault"). Held, bit for bit: the mesh
    run against the --split-step one (every amp, every scale's G and D on
    every rank), and the ranks against each other at the end of every
    scale; scale 1's amp (the first calibration after training, scale 0's
    iterations) within DP_TRAIN_REL of one process's; one experiment dir
    a run, the chunk mode at every scale. The planted fault must break a
    bar that the sound run holds. The later amps and every scale's netG
    (weights and running statistics apart) are reported against one
    process beside what the ulp does to one process: the random
    full-width model amplifies a rounding a thousandfold (phase 19) and
    every Adam step compounds it. Every reading is printed before the
    checks."""
    out, problems = {}, []
    mesh_mode = f"graph ({CARDS} NCCL ranks)"
    want_modes = {"one": "graph", "ulp": "graph", "graph": mesh_mode,
                  "split": "eager (split-step)", "fault": mesh_mode}
    for kind in ("image", "baselines"):
        runs, secs = {}, {}
        for variant in ("one", "ulp", "graph", "split") + (
                ("fault",) if kind == "image" else ()):
            run = os.path.join(work, f"cli_{kind}_{variant}")
            t0 = time.perf_counter()
            if variant in ("one", "ulp"):
                cli_variant(kind, variant, run, [])
                torch.cuda.empty_cache()
            else:
                mesh_cli(kind, variant, run)
            secs[variant] = round(time.perf_counter() - t0, 1)
            runs[variant] = read_cli_run(torch, run)
        one = runs["one"]
        res = {"mesh": "--mesh-data 2 --mesh-sp 2, torchrun"
               if kind == "image" else f"--mesh-sp {CARDS}, --dist-* flags",
               "s": secs}
        for variant, r in runs.items():
            want = [want_modes[variant]] * 10
            n_ranks = 1 if variant in ("one", "ulp") else CARDS
            if r["modes"] != want or len(r["states"]) != n_ranks \
                    or len(r["amps"]) != 10:
                problems.append(f"{kind} {variant}: modes {r['modes']}, "
                                f"{len(r['states'])} ranks' states, amps "
                                f"{r['amps']}")
        for variant in ("ulp", "graph", "fault"):
            if variant not in runs:
                continue
            r = runs[variant]
            rels = [abs(a - b) / abs(b) for a, b in zip(r["amps"],
                                                        one["amps"])]
            diffs = [ckpt_diffs(g, g1) for g, g1 in zip(r["netG"],
                                                        one["netG"])]
            res[variant] = {
                "amps_rel_vs_one": rels,
                "netG_weights_max_abs_vs_one": [d[0] for d in diffs],
                "netG_running_stats_max_rel_vs_one": [d[1] for d in diffs]}
        for variant in ("graph", "split", "fault"):
            if variant in runs:
                res.setdefault(variant, {})["ranks_differ"] = {
                    str(k): v for k, v in
                    ranks_differ(runs[variant]["states"]).items()}
        graph, split = runs["graph"], runs["split"]
        res["graph_vs_split_bit_equal"] = {
            "amps": graph["amps"] == split["amps"],
            "G_D_every_scale_every_rank": graph["states"] == split["states"]}
        amp1 = res["graph"]["amps_rel_vs_one"][1]
        if not all(res["graph_vs_split_bit_equal"].values()):
            problems.append(f"{kind}: graph vs --split-step on {CARDS} "
                            f"ranks {res['graph_vs_split_bit_equal']}")
        for variant in ("graph", "split"):
            if res[variant]["ranks_differ"]:
                problems.append(f"{kind} {variant}: the ranks differ "
                                f"{res[variant]['ranks_differ']}")
        if not amp1 <= DP_TRAIN_REL:
            problems.append(f"{kind}: scale 1's amp {amp1} from one "
                            "process's")
        if "fault" in runs:
            fault = res["fault"]
            fault["caught_by"] = [name for name, caught in (
                ("ranks_differ", bool(fault["ranks_differ"])),
                ("amp_1", fault["amps_rel_vs_one"][1] > DP_TRAIN_REL))
                if caught]
            if not fault["caught_by"]:
                problems.append(f"{kind}: planted {CLI_FAULT} passed every "
                                "bar")
        out[kind] = res
        print(f"  (d) {kind} CLI, {CARDS} NCCL ranks ({res['mesh']}) vs "
              "1 process (TF32 off): " + json.dumps(res), flush=True)
    check(not problems, "(d): " + "; ".join(problems))
    return out


def card_train_checks(torch, ranks, one, key, what, one_key=None):
    """Case (a), (b) or (c) of --cards: `key` of each rank's results
    against `one_key` (default `key`) of this process's: the mode, ranks
    bit-equal, graph == eager bit for bit, the captured collectives, the
    first iteration within DP_TRAIN_REL. Returns the case's JSON."""
    legs = [r[key] for r in ranks]
    ref = one[one_key or key]
    want = f"graph ({CARDS} NCCL ranks)"
    check(all(leg["mode"] == want for leg in legs),
          f"{what}: modes {[leg['mode'] for leg in legs]}")
    for part in ("G", "D"):
        same = all(torch.equal(v, leg[part][n]) for leg in legs[1:]
                   for n, v in legs[0][part].items())
        check(same, f"{what}: the ranks' {part} differ")
    check(all(leg["first"]["metrics"] == legs[0]["first"]["metrics"]
              for leg in legs), f"{what}: the ranks' metrics differ")
    calls = [(leg["collectives_captured"],
              leg["collectives_per_eager_iteration"]) for leg in legs]
    check(all(c == e > 0 for c, e in calls)
          and all(leg["host_syncs_in_capture"] == [0] for leg in legs),
          f"{what}: collectives (captured, eager) {calls}, host syncs "
          f"{[leg['host_syncs_in_capture'] for leg in legs]}")
    check(all(leg["graph_first_bit_equal"] and leg["graph_vs_eager_bit_equal"]
              for leg in legs),
          f"{what}: graph vs eager under NCCL's defaults: iteration 1 "
          f"bit-equal {[leg['graph_first_bit_equal'] for leg in legs]}, "
          "the other iterations' max diff "
          f"{[leg['graph_vs_eager_max_diff'] for leg in legs]}")
    rel = first_iteration_rel(legs[0]["first"], ref["first"])
    check(max(rel.values()) <= DP_TRAIN_REL,
          f"{what}: {CARDS} ranks vs 1 process: {rel}")
    g_par, g_run = param_diffs(legs[0]["G"], ref["G"])
    return {
        "ranks": CARDS, "backend": ranks[0]["backend"],
        "batch": legs[0]["batch"], "scale": DP_SCALE,
        "iterations": legs[0]["iterations"], "mode": want, **rel,
        "ranks_bit_equal": True,
        "graph_first_bit_equal": [leg["graph_first_bit_equal"]
                                  for leg in legs],
        "graph_vs_eager_bit_equal": [leg["graph_vs_eager_bit_equal"]
                                     for leg in legs],
        "graph_vs_eager_max_diff": max(leg["graph_vs_eager_max_diff"]
                                       for leg in legs),
        "G_param_max_diff_vs_1_process": g_par,
        "G_running_stats_max_rel_vs_1_process": g_run,
        "steps_per_s_1_process_eager": ref["eager_steps_per_s"],
        "steps_per_s_1_process_graph": ref.get("graph_steps_per_s"),
        "steps_per_s_eager_per_rank": [leg["eager_steps_per_s"]
                                       for leg in legs],
        "steps_per_s_graph_per_rank": [leg["graph_steps_per_s"]
                                       for leg in legs],
        "collectives_per_iteration": calls[0][0],
        "host_syncs_in_capture": 0,
        "nccl_share_eager_per_rank": [leg["nccl_share_eager"]["nccl_share"]
                                      for leg in legs],
        "nccl_share_graph_per_rank": [leg["nccl_share_graph"]["nccl_share"]
                                      for leg in legs],
        "nccl_ms_graph_rank0": legs[0]["nccl_share_graph"],
        "nccl_share_1_process_graph": ref.get("nccl_share_graph", {}).get(
            "nccl_share"),
        "peak_gb_per_rank": [leg["peak_gb"] for leg in legs],
        "peak_gb_1_process": ref["peak_gb"],
        "capture_s_per_rank": [leg["capture_s"] for leg in legs],
        "graph_pool_gb_rank0": legs[0]["graph_pool_gb"],
        "conv_heights_per_rank": [leg["conv_rows"] for leg in legs]}


def phase_cards(torch, k1, ckpt, clis_only=False):
    """--cards 4 (module doc): the ranks' cases (a)-(c), (e) and (f)
    unless `clis_only`, then the CLIs' (d); fails on any check."""
    n = torch.cuda.device_count()
    check(n >= CARDS, f"--cards {CARDS} needs {CARDS} cards; this machine "
          f"has {n}")
    t_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="hpv_cards_")
    out = {} if clis_only else card_rank_cases(torch, k1, ckpt, work)
    out["clis"] = card_clis(torch, work)
    shutil.rmtree(work, ignore_errors=True)
    print(f"  --cards {CARDS} took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return out


def card_rank_cases(torch, k1, ckpt, work):
    """--cards (a)-(c), (e) and (f): this process's cases on card 0, then
    the ranks'; fails on any check."""
    import numpy as np

    from hpvaegan_tpu_torch.parallel import mesh

    image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
    cfg = full_width_config(image_path=image)
    os.makedirs(os.path.join(work, "image"))
    write_experiment(os.path.join(work, "image"), cfg, ckpt)
    vcfg, _ = video_config()
    os.makedirs(os.path.join(work, "video"))
    write_experiment(os.path.join(work, "video"), vcfg,
                     random_jax_checkpoint(vcfg, SEED, ndim=3))
    one, none = {}, mesh.DataGroup()
    t0 = time.perf_counter()
    with exact_math(torch):
        for d, _ in CARD_MESHES:
            one[(2, d)] = card_leg(torch, none, 2, d)
            one[(3, d)] = card_leg(torch, none, 3, d, graph=False)
        one["csg"] = card_leg(torch, none, 3, 1, "GeneratorCSG", graph=False)
        one["eval_image"] = card_eval_leg(
            torch, os.path.join(work, "image"), 2, 1)
        one["eval_video"] = card_eval_leg(
            torch, os.path.join(work, "video"), 3, 1)
        k1.fused_upscale_noise_2d.launches = 0
        one["sampler"] = dp_sampler_leg(torch, k1, os.path.join(
            work, "image"), none)
    check(all(one[(2, d)]["mode"] == "graph" for d, _ in CARD_MESHES),
          "one process's 2D chunks are not graphs")
    torch.cuda.empty_cache()
    print(f"  one process on card 0: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    ranks = join_ranks(torch, start_ranks(work, kind="cards", ranks=CARDS),
                       work, kind="cards", ranks=CARDS)
    print(f"  the {CARDS} ranks' processes took "
          f"{time.perf_counter() - t0:.1f} s (per case: "
          f"{[r['s'] for r in ranks[:1]]})", flush=True)
    check([r["backend"] for r in ranks] == ["nccl"] * CARDS
          and [r["device"] for r in ranks] == [f"cuda:{r}"
                                               for r in range(CARDS)],
          f"ranks' backends and cards {[(r['backend'], r['device']) for r in ranks]}")
    out = {"cards": [r["card"] for r in ranks]}
    for ndim, what in ((2, "(a) 2D"), (3, "(b) 3D")):
        for d, s in CARD_MESHES:
            name = f"{what} full-width scale {DP_SCALE}, --mesh-data {d} " \
                f"--mesh-sp {s}"
            res = card_train_checks(torch, ranks, one, (ndim, d, s), name,
                                    (ndim, d))
            rows = res["conv_heights_per_rank"]
            h = 192 // s
            check(all((h + 2 in r) == (s > 1) for r in rows),
                  f"{name}: the sharded convolutions' heights {rows}")
            out[(ndim, d, s)] = res
            print(f"  {name} (batch {d}), {CARDS} NCCL ranks, chunk graphs "
                  "vs eager, vs 1 process (TF32 off): " + json.dumps(res),
                  flush=True)
    res = card_train_checks(torch, ranks, one, "csg",
                            f"(c) GeneratorCSG --mesh-sp {CARDS}")
    rows = res["conv_heights_per_rank"]
    check(48 + 2 in rows[1] and rows[1] == rows[2] and rows[0] == rows[3]
          and set(rows[0]) != set(rows[1]),
          f"(c): the sharded convolutions' heights {rows}")
    out["csg"] = res
    print(f"  (c) GeneratorCSG vs WDiscriminatorBaselines, full-width scale "
          f"{DP_SCALE}, batch 1, --mesh-sp {CARDS} in unequal padded shards "
          "(TF32 off): " + json.dumps(res), flush=True)
    evals = {}
    for kind, metric in (("eval_image", "SIFID"), ("eval_video", "SVFID")):
        vals = [r[kind][metric] for r in ranks]
        rel = abs(vals[0] - one[kind][metric]) / abs(one[kind][metric])
        check(len(set(vals)) == 1 and math.isfinite(vals[0])
              and rel <= 1e-3, f"(e) {metric} per rank {vals} vs 1 process "
              f"{one[kind][metric]}")
        evals[metric] = {"per_rank": vals, "1_process": one[kind][metric],
                         "rel_diff": rel,
                         "s_per_rank": [round(r[kind]["s"], 2)
                                        for r in ranks],
                         "s_1_process": round(one[kind]["s"], 2)}
    samp = [r["sampler"] for r in ranks]
    check(all(s["rows"] == DP_SAMPLES // CARDS for s in samp)
          and all(np.array_equal(s["samples"], samp[0]["samples"])
                  for s in samp), "(e) the ranks' gathered samples")
    err = float(np.abs(samp[0]["samples"]
                       - one["sampler"]["samples"]).max())
    launches = [s["launches"] for s in samp]
    check(err <= 1e-4 and launches == [9] * CARDS
          and one["sampler"]["launches"] == 9,
          f"(e) sharded sampler vs 1 process: err {err}, K1 launches per "
          f"rank {launches}, one process {one['sampler']['launches']}")
    evals["sampler"] = {
        "ranks_x_samples": [CARDS, DP_SAMPLES // CARDS], "max_abs_err": err,
        "k1_launches_per_rank": launches,
        "k1_launches_1_process": one["sampler"]["launches"],
        "s_per_rank": [round(s["s"], 4) for s in samp],
        "s_1_process": round(one["sampler"]["s"], 4)}
    out["eval"] = evals
    print(f"  (e) eval_image / eval_video --mesh-data {CARDS} "
          f"--on-device-fid, {DP_SAMPLES} samples, and the moving-stat "
          f"sampler with pallas_fused_sampling, {CARDS} x "
          f"{DP_SAMPLES // CARDS} vs 1 x {DP_SAMPLES}: " + json.dumps(evals),
          flush=True)
    planted_rel = {}
    for fault, (d, s) in CARD_FAULTS:
        legs = [r[fault] for r in ranks]
        check(all(leg["mode"] == f"graph ({CARDS} NCCL ranks)"
                  and leg["graph_first_bit_equal"] for leg in legs),
              f"(f) {fault}: not a graph equal to its eager iteration")
        rels = [first_iteration_rel(leg["graph_first"], one[(2, d)]["first"])
                for leg in legs]
        planted_rel[fault] = {k: max(r[k] for r in rels) for k in rels[0]}
        check(max(planted_rel[fault].values()) > DP_TRAIN_REL,
              f"(f) planted fault {fault} reads {planted_rel[fault]}, "
              f"within DP_TRAIN_REL {DP_TRAIN_REL}")
    out["faults"] = planted_rel
    print(f"  (f) planted faults, 2D graph-replayed iteration 1 on {CARDS} "
          f"ranks vs 1 process (the largest rank's reading; bar "
          f"{DP_TRAIN_REL}): " + json.dumps(planted_rel), flush=True)
    return out


def video_at(cfg, scale_idx):
    """A copy of the video config at `scale_idx`: its fps, time depth and
    rate index."""
    from hpvaegan_tpu_torch.utils import pyramid

    fps, td, fps_index = pyramid.get_fps_td_by_index(
        scale_idx, cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps,
        cfg.fps_lcm)
    return dataclasses.replace(cfg, scale_idx=scale_idx, fps=fps, td=td,
                               fps_index=fps_index)


def cards_main(clis_only):
    """`chip_smoke.py --cards 4 [--clis-only]`: the mesh on four cards
    (module doc)."""
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not installed: {e}")
    if not torch.cuda.is_available():
        fail(f"no CUDA device: --cards {CARDS} needs {CARDS} NVIDIA cards")
    try:
        import hpvaegan_tpu_torch
        from hpvaegan_tpu_torch.ops import cuda_build
        from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1
    except ImportError as e:
        fail(f"run from the root of a checkout of the repo: {e}")
    pkg = os.path.dirname(os.path.abspath(hpvaegan_tpu_torch.__file__))
    check(pkg.startswith(HERE + os.sep), f"imported {pkg}, not this checkout")
    t0 = time.perf_counter()
    cuda_build.load("upsample_noise")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    cards = smi.stdout.strip().splitlines()
    print(f"--cards {CARDS}: built upsample_noise in "
          f"{time.perf_counter() - t0:.2f} s; cards: {cards}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda} NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    cfg = full_width_config(image_path=os.path.join(
        HERE, "data", "imgs", "air_balloons.jpg"))
    phase_cards(torch, k1, random_jax_checkpoint(cfg, SEED), clis_only)
    for line in cards:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--cards":
        check(sys.argv[2:3] == [str(CARDS)]
              and sys.argv[3:] in ([], ["--clis-only"]),
              f"--cards takes {CARDS}: chip_smoke.py --cards {CARDS} "
              "[--clis-only]")
        cards_main(sys.argv[3:] == ["--clis-only"])
        return
    if len(sys.argv) > 1 and sys.argv[1].endswith("-worker"):
        # a rank of start_ranks: SIGUSR1 (join_in_group) prints its stacks
        from hpvaegan_tpu_torch.utils.logger import register_stack_dump

        register_stack_dump()
    if len(sys.argv) > 1 and sys.argv[1] == "--cards-worker":
        cards_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--cards-cli":
        cards_cli(*sys.argv[2:])
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--dp-worker":
        dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                  sys.argv[5] if len(sys.argv) > 5 else None)
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--sp-worker":
        sp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                  sys.argv[5] if len(sys.argv) > 5 else None)
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--spb-worker":
        spb_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                   sys.argv[5] if len(sys.argv) > 5 else None)
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--serving-draws":
        serving_draws_worker(sys.argv[2])
        return
    try:
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        fail(f"PyTorch is not installed: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one NVIDIA card")
    try:
        import hpvaegan_tpu_torch
        from hpvaegan_tpu_torch.ops import cuda_build
        from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1
        from hpvaegan_tpu_torch.utils import pyramid
    except ImportError as e:
        fail(f"run from the root of a checkout of the repo: {e}")
    pkg = os.path.dirname(os.path.abspath(hpvaegan_tpu_torch.__file__))
    check(pkg.startswith(HERE + os.sep), f"imported {pkg}, not this checkout")
    t_start = time.perf_counter()
    runner_build = RunnerBuild()
    runner_build.start()

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    cuda_build.load("upsample_noise")
    print(f"  built upsample_noise in {time.perf_counter() - t0:.2f} s "
          f"(ptxas: " + " | ".join(
              ln.strip() for r in cuda_build.build_logs.values()
              for ln in r.splitlines() if "registers" in ln) + ")", flush=True)
    smi = smi_line()
    print(f"  card: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)

    cfg = full_width_config()
    sizes = [pyramid.scale_size_2d(i, cfg.scale_factor, cfg.stop_scale,
                                   cfg.img_size, cfg.ar)[1]
             for i in range(cfg.stop_scale + 1)]
    print(f"phase 2: K1 vs plain at B={BATCH}, sizes {sizes}", flush=True)
    rows, err = phase_kernel(torch, F, k1, sizes)

    print("phase 3: train_mode=False sampler, pallas_fused_sampling, "
          f"{BATCH} samples at full width", flush=True)
    ckpt = random_jax_checkpoint(cfg, SEED)
    launches, timings, prof = phase_sampler(torch, k1, ckpt)

    print("phase 4: eval_image CLI on a JAX-format experiment dir", flush=True)
    phase_cli(torch, k1, ckpt)

    print("phase 5: one training iteration, card vs CPU", flush=True)
    phase_step_parity(torch, tiny_config())

    # phases 6 and 11 leave their experiments here for phase 13
    work = tempfile.TemporaryDirectory(prefix="hpv_runs_")
    print("phase 6: train_image CLI at full width, then eval_image",
          flush=True)
    image_run = phase_train_cli(torch, k1, work.name)

    print("phase 7: training step timing at full width, batch 1", flush=True)
    phase_step_timing(torch)

    vcfg, _ = video_config()
    vsizes = video_sizes(vcfg)
    check([s[0] for s in vsizes] == [4, 4, 4, 5, 5, 5, 7, 7, 7, 13]
          and vsizes[0][1:] == [24, 33] and vsizes[-1][1:] == [192, 257],
          f"video pyramid {vsizes}")
    print(f"phase 8: video sampler, {BATCH} samples at full width, scales "
          f"(T, H, W) {vsizes}, z td {vcfg.td}", flush=True)
    vckpt = random_jax_checkpoint(vcfg, SEED, ndim=3)
    video = phase_video_sampler(torch, k1, vcfg, vckpt)

    print("phase 9: eval_video CLI on a JAX-format experiment dir",
          flush=True)
    phase_video_cli(torch, k1, vcfg, vckpt)
    del vckpt

    print("phase 10: one video training iteration, card vs CPU", flush=True)
    from hpvaegan_tpu_torch.data.video import SingleVideoDataset
    tiny = tiny_config(video_path=os.path.join(HERE, "data", "vids",
                                               "synthetic.avi"),
                       max_frames=5, sampling_rates=[2, 1], hflip=True,
                       batch_size=2)
    SingleVideoDataset(tiny, "cpu")  # sets org_fps, ar, fps_lcm
    phase_step_parity(torch, tiny, ndim=3)

    print("phase 11: train_video CLI at full width, then eval_video",
          flush=True)
    video_run = phase_video_train_cli(torch, k1, work.name)

    print("phase 12: video training step timing at full width, batch 1",
          flush=True)
    phase_video_step_timing(torch)

    print("phase 13: kill and resume the full-width image and video runs",
          flush=True)
    t0 = time.perf_counter()
    phase_resume(torch, k1, work.name, image_run["exp"], video_run["exp"])
    print(f"  phase 13 took {time.perf_counter() - t0:.1f} s", flush=True)
    work.cleanup()

    print("phase 14: GeneratorVAE_nb (2D) at full width", flush=True)
    nb = phase_vae_nb(torch, k1, timings["fused_moving"])

    print("phase 15: the CSG/SG video baselines", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hpv_base_") as run:
        phase_baselines(torch, k1, run)
    print(f"  phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("phase 16: the training flags", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hpv_flags_") as run:
        phase_flags(torch, k1, run)
    print(f"  phase 16 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("phase 17: on-device SIFID/SVFID and checkpoint interop",
          flush=True)
    t0 = time.perf_counter()
    phase_ondevice(torch, k1, ckpt)
    print(f"  phase 17 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("phase 18: export and native serving", flush=True)
    t0 = time.perf_counter()
    scale9_video = {}

    def beside_export():
        t1 = time.perf_counter()
        print("  phase 22 (a) at scale 9, 3D and CSG (device-bound), while "
              "the export CLIs compile", flush=True)
        scale9_video.update(chunk_scale9_video(torch))
        print(f"  phase 22 (a) at scale 9 took {time.perf_counter() - t1:.1f}"
              " s", flush=True)

    phase_serving(torch, k1, ckpt, runner_build, beside_export)
    print(f"  phase 18 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("phase 19: multi-process and data-parallel training and eval",
          flush=True)
    t0 = time.perf_counter()
    dp = phase_data_parallel(torch, k1, ckpt)
    print(f"  phase 19 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("phase 20: the spatial mesh (--mesh-sp 2, two ranks splitting H; "
          "(d) the baselines on --mesh-sp 4)", flush=True)
    t0 = time.perf_counter()
    phase_spatial(torch, k1)
    print(f"  phase 20 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("phase 21: GeneratorVAE_nb (3D) at full width", flush=True)
    t0 = time.perf_counter()
    nb3 = phase_vae_nb_3d(torch, k1,
                          video["per_sample_bn"]["videos_per_s"])
    print(f"  phase 21 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("phase 22: the training chunk (--steps-per-call: CUDA-graph "
          "replays of the iteration) against --split-step", flush=True)
    t0 = time.perf_counter()
    chunked = phase_chunk(torch, k1, scale9_video)
    print(f"  phase 22 took {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = [{
        "name": "fused_upscale_noise_2d",
        "route": "cuda",
        "source": "hpvaegan_tpu_torch/csrc/upsample_noise.cu",
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": sum(r["ms"] for r in rows),
        "device_ms": sum(r["device_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                     else "operations"),
        "library_ms": sum(r["library_ms"] for r in rows),
        "launches_per_rank_sharded": dp["sampler"]["k1_launches_per_rank"],
        "launches_vae_nb_3d": nb3["k1_launches"],
        "launches_chunked_training": chunked["main"]["k1_launches"],
    }]
    print("  times are sums over the 9 stage shapes of one 64-sample forward;"
          f" launches: phase 3's GeneratorHPVAEGAN forward ({launches}), "
          f"phase 14's GeneratorVAE_nb forward ({nb['launches']}), phase "
          "15's baselines (0), phase 16's training-flag runs (0), phase "
          "17's on-device eval and interop (0), phase 18's export and "
          "serving (0), phase 19's training (0) and sharded sampler "
          f"({dp['sampler']['k1_launches_per_rank']} per rank), phase 20's "
          "spatial-mesh training (0) and (d)'s baselines on 4 ranks (0 in "
          f"each), phase 21's 3D GeneratorVAE_nb ({nb3['k1_launches']}), "
          "phase 22's graph-captured training "
          f"({chunked['main']['k1_launches']})",
          flush=True)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
