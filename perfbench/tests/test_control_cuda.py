"""The control of each cell, at the cell's own size on the card: the
program's own bfloat16 path (the reference in bfloat16, for the sampler)
in place of float32 with TF32 comes out not correct, and so does each
fault the cell can have, where the program as configured comes out
correct. Marked `cuda`: skips without the cell's cards."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import common, control

SEED = 20260417


def _cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA card(s)")


@pytest.mark.cuda
@pytest.mark.parametrize("name,faults", [
    ("img-s9-train", ["frozen"]), ("vid-s9-train", ["frozen"]),
    ("img-sample64", ["altered_sample"])])
def test_the_control_fails(name, faults):
    _cards(1)
    common.set_cache_dirs()
    found = control.readings(torch, common.cell(name), [SEED],
                             ["program", "bf16"] + faults)
    assert [r["correct"] for r in found] == \
        [True, False] + [False] * len(faults), found


@pytest.mark.cuda
def test_the_mesh_control_fails():
    _cards(4)
    variants = ["program", "bf16", "frozen", "half_batch", "no_exchange",
                "no_bn_sums"]
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.control", "--workload",
         "img-s9-train-dp2sp2", "--seeds", str(SEED), "--variants",
         ",".join(variants)], cwd=common.ROOT, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    found = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith("{")]
    assert [r["correct"] for r in found] == [True] + [False] * 5, found
