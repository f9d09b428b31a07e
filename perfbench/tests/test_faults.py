"""A run drives the rest of the harness with the timed path broken
underneath and reports `correct` false, for each fault its cell can
have; and true when nothing is broken. Tiny cells on the CPU, without
the look for a card; the mesh cell as four gloo ranks."""

import json
import socket
import subprocess
import sys

import pytest
import torch

from perfbench import common
from perfbench.tests import faults, tiny


@pytest.mark.parametrize("name,fault", [
    ("img-s9-train", None), ("img-s9-train", "frozen"),
    ("vid-s9-train", None), ("vid-s9-train", "frozen"),
    ("img-sample64", None), ("img-sample64", "altered_sample")])
def test_one_card(name, fault, monkeypatch):
    from hpvaegan_tpu_torch.parallel import sampling

    monkeypatch.setattr(sampling, "_host_copy", sampling._host_copy)
    ctx = {}
    if fault:
        faults.plant(fault, ctx)
    work = {"samples": 3} if name == "img-sample64" else \
        {"steps_per_call": 2}
    result = tiny.run(torch, tiny.cell(name, **work), seconds=0.2, **ctx)
    assert result["correct"] is (fault is None), result["checks"]


@pytest.mark.parametrize("fault", [None, "frozen", "half_batch",
                                   "no_exchange", "no_bn_sums"])
def test_mesh(fault, tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "result.json"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "perfbench.tests.mesh_rank",
         "img-s9-train-dp2sp2", str(r), str(port), str(out)]
        + ([fault] if fault else []), cwd=common.ROOT) for r in range(4)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert rcs == [0, 0, 0, 0]
    result = json.loads(out.read_text())
    assert result["correct"] is (fault is None), result["checks"]
