"""Build the native runner (runner.cc) against the installed PyTorch.

    python -m hpvaegan_tpu_torch.native.build     # prints the binary's path

`g++` compiles it with PyTorch's include and library paths, its C++ ABI
flag and an rpath to `torch/lib`, into `hpvaegan_tpu_torch/_build/`
(listed in .gitignore), named by a hash of the source and the command, as
ops/cuda_build.py names the kernels: an edited runner is rebuilt, a built
one reused. Where the wheel has CUDA, the runner links libtorch_cuda so
that CUDA packages load. A failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "runner.cc"
BUILD_DIR = NATIVE_DIR.parent / "_build"


def compile_command(out: str) -> List[str]:
    import torch
    from torch.utils import cpp_extension

    lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    cuda = [n for n in ("torch_cuda", "c10_cuda")
            if os.path.exists(os.path.join(lib, f"lib{n}.so"))]
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    return ([cxx, "-std=c++17", "-O2", f"-D_GLIBCXX_USE_CXX11_ABI={abi}"]
            + [f"-I{p}" for p in cpp_extension.include_paths()]
            + [str(SOURCE), "-o", out, f"-L{lib}", f"-Wl,-rpath,{lib}",
               "-Wl,--no-as-needed"]
            + [f"-l{n}" for n in ["torch", "torch_cpu", "c10"] + cuda])


def runner_path() -> Path:
    """The runner binary for this source and this PyTorch."""
    key = SOURCE.read_bytes() + " ".join(compile_command("")).encode()
    return BUILD_DIR / f"runner_{hashlib.sha256(key).hexdigest()[:12]}"


def build() -> Path:
    """The built runner, compiling it first if needed."""
    out = runner_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(compile_command(str(tmp)),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"runner build failed: g++ exit "
                               f"{res.returncode}\n{res.stdout[-4000:]}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    return out


if __name__ == "__main__":
    print(build())
