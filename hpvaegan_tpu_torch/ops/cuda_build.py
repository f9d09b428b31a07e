"""Build and load the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into a shared library under `hpvaegan_tpu_torch/_build/`
(listed in .gitignore), then loaded with `ctypes`. Libraries are named by a
hash of their source, so an edited kernel is rebuilt and a built one is
reused. Nothing here runs at import time: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# the nvcc/ptxas output of each kernel compiled by this process
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def load(name: str) -> ctypes.CDLL:
    """The built library of `name`, compiling it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                  str(CSRC_DIR / f"{name}.cu")],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                                   f"{res.returncode}\n{res.stdout}")
            os.replace(tmp, out)  # atomic: a concurrent build sees all or none
            build_logs[name] = res.stdout
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
    return lib
