#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hpvaegan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, each of which exits non-zero on a failed check:
  1. build   the CUDA kernel from csrc/ (nvcc, sm_90a)
  2. kernel  K1 (fused upscale+noise) against its plain PyTorch version at
             the nine full-width stage shapes, B=64; its noise statistics;
             times of the kernel, the plain version and one PyTorch
             yardstick (F.interpolate + randn FMA, never used by the port)
  3. sampler the kernel's main path: generate_samples(train_mode=False) with
             pallas_fused_sampling, 64 samples of the full-width model
             (img 256, nfc 64, num_layer 5, latent 128, 10 scales); K1 must
             launch 9 times per forward; kernel path == plain path at amps 0
  4. CLI     python -m hpvaegan_tpu_torch.eval_image on an experiment dir
             written in the JAX package's format (args.txt,
             intermediate.json, netG_9.ckpt from a numpy seed): per-sample
             BatchNorm sampling, PNGs, SIFID
Then it prints the kernels' JSON line, the card's name and power limit as
nvidia-smi gives them, and last {"ok": true, "device": {...}}.

Weights are random (numpy seed), He-normal convs so activations keep unit
scale through the stacks. Nothing here imports JAX or the JAX package.
"""

import contextlib
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


def full_width_config(**kw):
    from hpvaegan_tpu_torch.config import Config

    cfg = Config(niter=1, num_samples=BATCH, **kw).finalize()
    cfg.scale_idx = cfg.stop_scale
    cfg.Noise_Amps = [1.0] + [0.3 * 0.8 ** k for k in range(cfg.stop_scale)]
    return cfg


def random_jax_checkpoint(cfg, seed):
    """A full-width generator at scale stop_scale as the JAX package's
    netG_<k>.ckpt pytree, every tensor drawn with numpy."""
    import numpy as np

    from hpvaegan_tpu_torch.models.networks_2d import GeneratorHPVAEGAN
    from hpvaegan_tpu_torch.tools.convert import to_jax

    rng = np.random.RandomState(seed)
    gen = GeneratorHPVAEGAN(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage()
    sd = {}
    for key, ref in gen.state_dict().items():
        shape = tuple(ref.shape)
        if key.endswith("running_var"):
            a = np.ones(shape)
        elif key.endswith("norm.weight"):
            a = 1.0 + 0.02 * rng.randn(*shape)
        elif len(shape) == 4:  # conv weights, OIHW
            a = rng.randn(*shape) * math.sqrt(2.0 / np.prod(shape[1:]))
        elif key.endswith(("weight_u", "weight_v")):
            a = rng.randn(*shape)
            a /= np.linalg.norm(a)
        else:  # biases, BN beta and running_mean
            a = np.zeros(shape)
        sd[key] = a.astype(np.float32)
    params, state = to_jax(sd)
    return {"params": params, "state": state}


def load_port_generator(cfg, ckpt, device):
    from hpvaegan_tpu_torch.models.networks_2d import GeneratorHPVAEGAN
    from hpvaegan_tpu_torch.tools.convert import from_jax

    gen = GeneratorHPVAEGAN(cfg)
    for _ in range(len(ckpt["params"]["body"])):
        gen.init_next_stage()
    gen.load_state_dict(from_jax(ckpt["params"], ckpt["state"]))
    return gen.to(device).eval()


def phase_kernel(torch, F, k1, sizes):
    """K1 vs its plain version at the 9 stage shapes of one forward."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows, err = [], 0.0
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
        check(e_clean <= 1e-5, f"stage {i}: clean differs by {e_clean}")
        check(e_noised <= 1e-5, f"stage {i}: noised differs by {e_noised}")
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
        print(f"  K1 stage {i + 1}: {h_in}->{h_out} ms {ms:.4f} plain "
              f"{plain_ms:.4f} library {library_ms:.4f} bound "
              f"{rows[-1]['bound_ms']:.4f} err {rows[-1]['max_abs_err']:.3g}",
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

    kernels = [{
        "name": "fused_upscale_noise_2d",
        "route": "cuda",
        "source": "hpvaegan_tpu_torch/csrc/upsample_noise.cu",
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                     else "operations"),
        "library_ms": sum(r["library_ms"] for r in rows),
    }]
    print("  times are sums over the 9 stage shapes of one 64-sample forward",
          flush=True)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
