"""The readers of the program's own spans and counters
(utils/profiling.py): the sampler's host copy and assembly, read in the
run's process, and the training phases and collectives, read from the
records perfbench/phases.py makes. Tiny cells on the CPU, without the
look for a card; the mesh as four gloo ranks."""

import json
import socket
import subprocess
import sys

import pytest
import torch

from perfbench import common, phases
from perfbench.tests import tiny

PHASES = {"batch": 1.0, "d.fake": 2.0, "d.forward": 3.0, "d.backward": 10.0,
          "d.exchange": 0.5, "d.optim": 1.5, "g.forward": 4.0,
          "g.backward": 5.0, "g.exchange": 0.25, "g.optim": 2.5,
          "metrics": 0.25}


@pytest.fixture
def spans():
    from hpvaegan_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def _read(metric, run):
    return common.reader(metric)(run)


def test_the_training_readers_read_the_records():
    other = dict(PHASES, **{"d.backward": 2.0, "d.exchange": 1.0})
    run = {"kind": "train", "chips": 4, "ranks": [
        {"phases": PHASES, "collectives": {"grad": [2, 3_000_000],
                                           "bn": [100, 500_000]}},
        {"phases": other, "collectives": {}}]}
    assert _read("d_backward_pct.train", run) == pytest.approx(
        100 * 10 / sum(PHASES.values()))
    assert _read("optim_ms.train", run) == 4.0
    assert _read("exchange_ms.train", run) == 1.25
    assert _read("collective_mb_per_iter", run) == 3.5
    one = dict(run, chips=1)
    assert _read("exchange_ms.train", one) is None
    assert _read("collective_mb_per_iter", one) is None
    # the records of a program without the spans, and the other kind
    bare = {"kind": "train", "chips": 4, "ranks": [{"trace": {}}] * 4}
    for m in phases.METRICS:
        assert _read(m, bare) is None
        assert _read(m, {"kind": "sample"}) is None


def test_the_sampler_readers_read_the_traced_requests(spans):
    """Off (the window), the program keeps nothing to read; on (as under
    the trace's profiler), the bytes on the host over the copy's time,
    and the assembly's ms per request."""
    run = {"kind": "sample"}
    tiny.run(torch, tiny.cell("img-sample64", samples=3), seconds=0.0)
    assert _read("d2h_gbps.sample", run) is None
    assert _read("assemble_ms.sample", run) is None
    spans.enable(True)
    tiny.run(torch, tiny.cell("img-sample64", samples=3), seconds=0.0)
    copied = spans.counters()["d2h_bytes"]
    count, seconds = spans.totals()["d2h"]
    assert _read("d2h_gbps.sample", run) == copied / seconds / 1e9 > 0
    assert spans.totals()["sample.assemble"][0] == count
    assert _read("assemble_ms.sample", run) > 0
    assert _read("d2h_gbps.sample", {"kind": "train"}) is None


def test_the_phase_tool_on_one_card(spans):
    out = phases.run_cell(torch, tiny.cell("img-s9-train", steps_per_call=2),
                          3, 0.0, kind="cpu", trace=0)
    assert out["correct"] is True
    assert list(out["ranks"][0]["phases"]) == [
        "batch", "d.fake", "d.forward", "d.backward", "d.exchange",
        "d.optim", "g.forward", "g.backward", "g.exchange", "g.optim",
        "metrics"]
    got = out["metrics"]
    assert 0 < got["d_backward_pct.train"] < 100 and got["optim_ms.train"] > 0
    assert got["exchange_ms.train"] is None
    assert got["collective_mb_per_iter"] is None
    assert not spans.enabled()


def test_the_phase_tool_on_the_mesh(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "result.json"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "perfbench.tests.phases_rank",
         "img-s9-train-dp2sp2", str(r), str(port), str(out)],
        cwd=common.ROOT) for r in range(4)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert rcs == [0, 0, 0, 0]
    result = json.loads(out.read_text())
    assert result["correct"] is True
    found = result["ranks"][0]["collectives"]
    assert all(found[k][0] > 0 for k in ("grad", "metric", "bn", "halo"))
    got = result["metrics"]
    assert got["collective_mb_per_iter"] == pytest.approx(
        sum(n for _, n in found.values()) / 1e6)
    assert got["exchange_ms.train"] > 0 and got["optim_ms.train"] > 0
