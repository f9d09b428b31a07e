#!/usr/bin/env python3
"""K1, the port's hand-written CUDA kernel, on one NVIDIA card at the shapes
and batch of its main path (correctness elsewhere on the card is the
`cuda`-marked tests', speed perfbench's; README.md, "On the card"):

    python3 chip_smoke.py          # from the root of a checkout, one card

  1. build   K1 from csrc/ (nvcc, sm_90a)
  2. kernel  K1 against its plain version at the nine stage shapes of the
             full-width model, B=64, bit for bit; its noise statistics and
             streams; per stage its time (CUDA events), its device time
             (one profiler window) and its byte / f32-operation bound
  3. sampler generate_samples(train_mode=False) with pallas_fused_sampling,
             64 samples of the full-width model: K1 launches 9 times in
             that forward, and at amps 0 (TF32 off) the kernel path gives
             the plain path's samples within 1e-4

A failed check exits 1. Last it prints the kernel's JSON line (sums over
the nine stages), the card's name and power limit, and {"ok": true, ...}.
Nothing here imports JAX or the JAX package.
"""

import json
import os
import subprocess
import sys

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


def check(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Mean time of fn() on the card over `reps` calls after one warm call."""
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
    on small stages."""
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
          f"the profiler saw {len(spans)} K1 launches of {reps * len(calls)}")
    return [sum(us for _, us in spans[i * reps:(i + 1) * reps]) / reps / 1e3
            for i in range(len(calls))]


def phase_kernel(torch, k1, sizes):
    """K1 against its plain version at the stage shapes of one forward."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows, calls = [], []
    for i in range(len(sizes) - 1):
        h_in, h_out = sizes[i], sizes[i + 1]
        hw = (h_out, h_out)
        x = torch.randn(BATCH, 3, h_in, h_in, device=dev, generator=g)
        seed = 1000 + i
        clean, noised = k1.fused_upscale_noise_2d(x, hw, 0.7, seed)
        bits = k1.philox_bits(seed, (BATCH, 3) + hw, dev)
        p_clean, p_noised = k1.fused_upscale_noise_2d_plain(x, hw, 0.7, bits)
        err = max(float((clean - p_clean).abs().max()),
                  float((noised - p_noised).abs().max()))
        # bit for bit: same tables, same op order, accurate libm, no FMA
        check(torch.equal(clean, p_clean) and torch.equal(noised, p_noised),
              f"stage {i + 1}: K1 differs from the plain version by {err}")
        c0, n0 = k1.fused_upscale_noise_2d(x, hw, 0.0, seed)
        check(torch.equal(c0, n0), f"stage {i + 1}: amp 0 changed the output")
        zeros = torch.zeros_like(x)
        c1, n1 = k1.fused_upscale_noise_2d(zeros, hw, 1.0, seed)
        noise = n1 - c1
        mean, std = float(noise.mean()), float(noise.std())
        check(abs(mean) < 0.05 and abs(std - 1) < 0.05,
              f"stage {i + 1}: noise mean {mean} std {std}")
        _, again = k1.fused_upscale_noise_2d(zeros, hw, 1.0, seed)
        check(torch.equal(again, n1), f"stage {i + 1}: same seed, other noise")
        per_sample = noise.flatten(1)
        check(bool((per_sample[1:] != per_sample[:1]).any(1).all()),
              f"stage {i + 1}: two samples drew the same noise")
        _, other = k1.fused_upscale_noise_2d(zeros, hw, 1.0, seed + 1)
        check(not torch.equal(other, n1),
              f"stage {i + 1}: a new seed left the noise unchanged")

        def call(x=x, hw=hw, seed=seed):
            return k1.fused_upscale_noise_2d(x, hw, 0.7, seed)

        calls.append(call)
        n_out = BATCH * 3 * h_out * h_out
        nbytes = 4 * (x.numel() + 2 * n_out) + 12 * 2 * h_out  # + tables
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        ops_ms = n_out * K1_FLOPS_PER_OUT / H100_F32_FLOPS * 1e3
        rows.append(dict(
            stage=i + 1, h_in=h_in, h_out=h_out, ms=cuda_ms(torch, call, 20),
            plain_ms=cuda_ms(torch, lambda: k1.fused_upscale_noise_2d_plain(
                x, hw, 0.7, k1.philox_bits(seed, (BATCH, 3) + hw, dev)), 5),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            max_abs_err=err))
    for row, dev_ms in zip(rows, kernel_device_ms(torch, calls, 20)):
        row["device_ms"] = dev_ms
        print(f"  K1 stage {row['stage']}: {row['h_in']}->{row['h_out']} ms "
              f"{row['ms']:.4f} device_ms {dev_ms:.4f} plain "
              f"{row['plain_ms']:.4f} bound {row['bound_ms']:.4f} "
              f"({row['bound_by']})", flush=True)
    return rows


def full_width_generator(torch, cfg):
    """The full-width generator at scale stop_scale on the card, He-normal
    (tools/step_parity.py::he_init_: activations keep unit scale through
    the stacks)."""
    from hpvaegan_tpu_torch.models import get_generator
    from hpvaegan_tpu_torch.tools.step_parity import he_init_

    gen = get_generator(cfg.generator)(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage()
    he_init_(gen, torch.Generator().manual_seed(SEED))
    return gen.to("cuda").eval()


def phase_sampler(torch, k1, cfg):
    """The kernel's main path at full width: one 64-sample forward."""
    import numpy as np

    from hpvaegan_tpu_torch.evaluation import generate_samples

    gen = full_width_generator(torch, cfg)
    generate_samples(cfg, gen, train_mode=False, seed=SEED)  # warm-up
    k1.fused_upscale_noise_2d.launches = 0
    out = generate_samples(cfg, gen, train_mode=False, seed=SEED + 1)
    launches = k1.fused_upscale_noise_2d.launches
    check(launches == cfg.stop_scale,
          f"K1 launched {launches} times in one forward, want "
          f"{cfg.stop_scale}")
    check(out.shape == (BATCH, 257, 257, 3), f"sample shape {out.shape}")
    check(bool(np.isfinite(out).all()), "non-finite samples")
    check(float(np.abs(out).max()) <= 1.0, "samples outside [-1, 1]")

    # kernel path against plain path at amps 0, TF32 off: same z, same samples
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg.Noise_Amps = [1.0] + [0.0] * cfg.stop_scale
    fused = generate_samples(cfg, gen, train_mode=False, seed=SEED + 7)
    cfg.pallas_fused_sampling = False
    plain = generate_samples(cfg, gen, train_mode=False, seed=SEED + 7)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32
    diff = float(np.abs(fused - plain).max())
    check(diff <= 1e-4, f"kernel path and plain path differ by {diff}")
    print(f"  K1 launches in one forward: {launches}; kernel path vs plain "
          f"path at amps 0: max |diff| {diff:.3g}", flush=True)
    return launches


def main():
    import torch

    import hpvaegan_tpu_torch
    from hpvaegan_tpu_torch.config import Config
    from hpvaegan_tpu_torch.ops import cuda_build
    from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1
    from hpvaegan_tpu_torch.utils.pyramid import scale_size_2d

    check(torch.cuda.is_available(), "no CUDA device: this needs one card")
    pkg = os.path.dirname(os.path.abspath(hpvaegan_tpu_torch.__file__))
    check(pkg.startswith(HERE + os.sep), f"imported {pkg}, not this checkout")

    print("phase 1: build", flush=True)
    cuda_build.load("upsample_noise")
    smi = smi_line()
    print(f"  card: {smi}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)

    cfg = Config(niter=1, num_samples=BATCH,
                 pallas_fused_sampling=True).finalize()
    cfg.scale_idx = cfg.stop_scale
    cfg.Noise_Amps = [1.0] + [0.3 * 0.8 ** k for k in range(cfg.stop_scale)]
    sizes = [scale_size_2d(i, cfg.scale_factor, cfg.stop_scale, cfg.img_size,
                           cfg.ar)[1] for i in range(cfg.stop_scale + 1)]
    print(f"phase 2: K1 vs plain at B={BATCH}, sizes {sizes}", flush=True)
    rows = phase_kernel(torch, k1, sizes)

    print(f"phase 3: train_mode=False sampler, pallas_fused_sampling, {BATCH} "
          "samples at full width", flush=True)
    launches = phase_sampler(torch, k1, cfg)

    kernels = [{
        "name": "fused_upscale_noise_2d",
        "route": "cuda",
        "source": "hpvaegan_tpu_torch/csrc/upsample_noise.cu",
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "device_ms": sum(r["device_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                     else "operations"),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
