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
             at full width, batch 1: steps/s over 20 iterations after 3
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
             iteration takes over 2 s; then scale 9 with TF32 off and
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
             flat-opt; 2D twice, in order and reversed, being host-bound):
             steps/s, D and G (or fused-iteration) ms, peak GB,
             and for bf16 one profiled iteration's GP image-sized
             convolutions with their kernels and TFLOP/s; (c) the main path
             train_video --compute-dtype bfloat16 --fused-dg at full width,
             10 scales x 2, then eval_video (finite SVFID, float32 samples,
             K1 launches 0), and train_image --paired-g --flat-opt
             --visualize --image-interval 2 --profile-dir, 10 x 4 (the
             img/ files, one trace with CUDA kernel events)
Then it prints the kernels' JSON line, the card's name and power limit as
nvidia-smi gives them, and last {"ok": true, "device": {...}}.

Weights are random (numpy seed), He-normal convs so activations keep unit
scale through the stacks. Nothing here imports JAX or the JAX package.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# the pl.pallas_call that K1 replaces
K1_REPLACES = "hpvaegan_tpu/ops/pallas/upsample_noise.py:111"
SEED = 0
BATCH = 64
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
        cfg.write_args_txt(os.path.join(exp, "args.txt"))
        with open(os.path.join(exp, "intermediate.json"), "w") as f:
            json.dump({"noise_amps": cfg.Noise_Amps,
                       "scale_idx": cfg.stop_scale}, f)
        with open(os.path.join(exp, f"netG_{cfg.stop_scale}.ckpt"), "wb") as f:
            pickle.dump(ckpt, f)
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


def image_train_args(run, *extra):
    """Phase 6's train_image flags (full width, 10 scales x 4 iterations)."""
    return ["--image-path", os.path.join(HERE, "data", "imgs",
                                         "air_balloons.jpg"),
            "--niter", "4", "--print-interval", "2", "--run-dir", run,
            "--checkname", "smoke", "--manualSeed", "1", *extra]


def video_train_args(run, *extra):
    """Phase 11's train_video flags (full width, 10 scales x 2
    iterations)."""
    return ["--video-path", os.path.join(HERE, "data", "vids",
                                         "balloons_pan.avi"),
            "--max-frames", "13", "--sampling-rates", "4", "3", "2", "1",
            "--niter", "2", "--print-interval", "1", "--run-dir", run,
            "--checkname", "smoke", "--manualSeed", "1", *extra]


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
    or 3D run: 3 warm-up and 20 timed iterations, cut to 2 and 3 when the
    second warm-up takes over 2 s."""
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
    cut = warm_s > 2.0
    reps = 3 if cut else 20
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
        "cut": f"second warm-up took {warm_s:.2f} s > 2 s: 2 warm-up, "
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
        cfg.write_args_txt(os.path.join(exp, "args.txt"))
        with open(os.path.join(exp, "intermediate.json"), "w") as f:
            json.dump({"noise_amps": cfg.Noise_Amps,
                       "scale_idx": cfg.stop_scale}, f)
        with open(os.path.join(exp, f"netG_{cfg.stop_scale}.ckpt"), "wb") as f:
            pickle.dump(ckpt, f)
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


def phase_video_train_cli(torch, k1, run):
    """The video training CLI at full width (TF32 off, deterministic cuDNN:
    phase 13 resumes against it), then eval_video on its output. The
    experiment stays in `run`."""
    import numpy as np

    from hpvaegan_tpu_torch import eval_video, train_video
    from hpvaegan_tpu_torch.training import trainer

    k1.fused_upscale_noise_2d.launches = 0
    with exact_math(torch):
        exp, train_s, scale_s = timed_scales(trainer, train_video.main,
                                             video_train_args(run))
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
    print(f"  trained 10 scales x 2 iterations in {train_s:.1f} s (TF32 off, "
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
    iteration counts cut as phase 12 cuts them); the bf16 variant
    profiled. 2D is host-bound, so its variants run twice, in order and
    then in reverse, and both rates are kept."""
    from hpvaegan_tpu_torch.data.image import SingleImageDataset

    out = {}
    image = os.path.join(HERE, "data", "imgs", "air_balloons.jpg")
    for ndim in (2, 3):
        if ndim == 2:
            base = full_width_config(image_path=image, batch_size=1)
            dataset = SingleImageDataset(base, "cuda")
            variants, counts = FLAG_VARIANTS, (3, 10, 3)
        else:
            base, dataset = video_config(batch_size=1)
            variants, counts = FLAG_VARIANTS[:4], (1, 2, 1)
        order = list(variants)
        if ndim == 2:
            order += order[::-1]
        for name, flags in order:
            cfg = dataclasses.replace(base, **flags)
            key = f"{ndim}D {name}"
            res = time_flag_variant(torch, cfg, dataset, ndim, *counts,
                                    profiled=name == "bf16" and key not in out)
            if key in out:
                out[key]["steps_per_s_again"] = res["steps_per_s"]
                key += " again"
            else:
                out[key] = res
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


def main():
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
    phase_video_sampler(torch, k1, vcfg, vckpt)

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
    }]
    print("  times are sums over the 9 stage shapes of one 64-sample forward;"
          f" launches: phase 3's GeneratorHPVAEGAN forward ({launches}), "
          f"phase 14's GeneratorVAE_nb forward ({nb['launches']}), phase "
          "15's baselines (0), phase 16's training-flag runs (0)",
          flush=True)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
