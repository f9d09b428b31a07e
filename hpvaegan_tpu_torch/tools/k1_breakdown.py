"""Where kernel K1's time goes, on one NVIDIA card.

    python -m hpvaegan_tpu_torch.tools.k1_breakdown [--h-in 204 --h-out 257]

Builds two variants of csrc/upsample_noise.cu beside the kernel itself and
times all three (CUDA events, best of three runs of 50 back-to-back
launches) at one stage shape, B=64, C=3:
  kernel      the kernel as it ships;
  memory      the same loads, upscale and stores, with the Philox call and
              the Box-Muller map replaced by one xor of the counter words;
  arithmetic  the same upscale, Philox and Box-Muller, with the stores
              replaced by a test that never holds (nothing is written);
and, for the rate the card writes at, PyTorch's fill_ of the kernel's
(2, B, C, H, W) output. The variants are made by text substitution on the
source, are built into hpvaegan_tpu_torch/_build/ and are used nowhere
else. Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..ops import cuda_build
from ..ops import fused_upscale_noise as k1

_PHILOX = "      philox4x32_10(ctr, key, 0u);\n"
_NOISE = ("box_muller(ctr[0], ctr[1])", "box_muller(ctr[2], ctr[3])")
_STORES = """      clean[o] = ya;
      noised[o] = __fadd_rn(ya, __fmul_rn(amp, box_muller(ctr[0], ctr[1])));
      if (has_b) {
        clean[o + 1] = yb;
        noised[o + 1] =
            __fadd_rn(yb, __fmul_rn(amp, box_muller(ctr[2], ctr[3])));
      }
"""
_NO_STORES = """      const float na = __fmul_rn(amp, box_muller(ctr[0], ctr[1]));
      const float nb = __fmul_rn(amp, box_muller(ctr[2], ctr[3]));
      if (ya + yb + na + nb == -1e30f) clean[o] = 0.0f;
"""


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"csrc/upsample_noise.cu no longer holds {old!r}")
    return src.replace(old, new)


def variant_sources() -> dict:
    src = (cuda_build.CSRC_DIR / "upsample_noise.cu").read_text()
    memory = _replace(src, _PHILOX, "")
    for words, cheap in zip(_NOISE, ("(ctr[0] ^ ctr[1])", "(ctr[2] ^ ctr[3])")):
        memory = _replace(memory, words, f"__uint_as_float({cheap} & 0x3f7fffffu)")
    return {"memory": memory, "arithmetic": _replace(src, _STORES, _NO_STORES)}


def _build(name: str, src: str):
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / f"k1_{name}.cu"
    so = cuda_build.BUILD_DIR / f"libk1_{name}.so"
    cu.write_text(src)
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                          str(so), str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"build of the {name} variant failed:\n{res.stdout}"
                           f"{res.stderr}")
    fn = ctypes.CDLL(str(so)).hpv_upsample_noise_2d
    fn.restype = ctypes.c_int
    fn.argtypes = k1._kernel().argtypes
    return fn


def _best_ms(fn, reps: int = 50, runs: int = 3) -> float:
    fn()
    best = float("inf")
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h-in", type=int, default=204)
    ap.add_argument("--h-out", type=int, default=257)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measurement needs one card")
    dev = torch.device("cuda")
    h_in, h_out, b = args.h_in, args.h_out, args.batch
    x = torch.randn(b, 3, h_in, h_in, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    tables, (bx, by) = k1._plan(h_in, h_in, h_out, h_out, dev)
    out = torch.empty((2, b, 3, h_out, h_out), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launcher(fn):
        def call():
            err = fn(x.data_ptr(), out.data_ptr(), tables.data_ptr(), b, 3,
                     h_in, h_in, h_out, h_out, k1._TILE_H, bx, by, 0.7, 7,
                     dev.index or 0, stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        return call

    fns = {"kernel": k1._kernel()}
    fns.update((name, _build(name, src))
               for name, src in variant_sources().items())
    ms = {name: _best_ms(launcher(fn)) for name, fn in fns.items()}
    ms["fill_output"] = _best_ms(lambda: out.fill_(1.0))
    nbytes = 4 * (x.numel() + out.numel())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    result = {"shape": f"{b}x3x{h_in}x{h_in} -> {h_out}x{h_out}",
              "block": [bx, by], "tile_h": k1._TILE_H,
              "bytes_bound_ms": nbytes / 3.35e12 * 1e3,
              "ms": {k: round(v, 4) for k, v in ms.items()}}
    print(smi)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
