"""The repo's standard-library run tools on the port's experiments:
scripts/compare_runs.py on two train_image experiments and on two
train_video --generator GeneratorVAE_nb experiments (each scored by the
port's eval CLI), and scripts/analyze_soak.py on a port logbook.

The tools read what the JAX trainer writes (intermediate.json, the
logbook's "[Scale K/Iter N]" and "scale K done in Ss (R it/s)" lines,
eval/metrics.json); the port writes the same. analyze_soak.py measures a
sustained rate from the logbook's timestamps, which have a resolution of
one second: the run it reads sleeps a second between the two logged
iterations of its last scale, and the tool is asked for that scale.
"""

import os
import subprocess
import sys
import time

import pytest

from hpvaegan_tpu_torch import eval_image, eval_video
from hpvaegan_tpu_torch import train_image, train_video
from hpvaegan_tpu_torch.training import trainer

from test_torch_trainer import TINY
from test_torch_video_training import TINY as VTINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name, *args):
    return subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                        name), *args],
                          capture_output=True, text=True, timeout=120)


def _sleep_after_first(n_stages):
    """A step_callback that sleeps a second after iteration 1 of the scale
    whose generator has `n_stages` stages."""
    def callback(done, st, metrics):
        if len(st.G.body) == n_stages and done == 1:
            time.sleep(1.1)
    return callback


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{kind: [exp_a, exp_b]} of two scored tiny runs per kind (seeds 1
    and 2); the second video run's last scale is logged a second apart.
    The root logger's handlers are restored afterwards."""
    import logging
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    base = tmp_path_factory.mktemp("runs")
    out = {"image": [], "video-vae-nb": []}
    orig = trainer.run_training
    try:
        for seed in ("1", "2"):
            out["image"].append(train_image.main(TINY + [
                "--run-dir", str(base / f"image{seed}"), "--niter", "2",
                "--manualSeed", seed]))
            eval_image.main(["--exp-dir", out["image"][-1], "--device", "cpu",
                             "--num-samples", "2", "--max-samples", "1"])
            if seed == "2":
                trainer.run_training = lambda cfg, saver, **kw: orig(
                    cfg, saver, step_callback=_sleep_after_first(4), **kw)
            try:
                out["video-vae-nb"].append(train_video.main(VTINY + [
                    "--run-dir", str(base / f"video{seed}"), "--generator",
                    "GeneratorVAE_nb", "--manualSeed", seed]))
            finally:
                trainer.run_training = orig
            eval_video.main(["--exp-dir", out["video-vae-nb"][-1],
                             "--device", "cpu", "--num-samples", "2",
                             "--max-samples", "1"])
        yield out
    finally:
        trainer.run_training = orig
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers, root.level = handlers, level


@pytest.mark.parametrize("kind,metric", [("image", "SIFID"),
                                         ("video-vae-nb", "SVFID")])
def test_compare_runs_reads_port_experiments(runs, kind, metric):
    """Exit 0, one amp row and one throughput row per scale, and the eval
    line with both scores."""
    a, b = runs[kind]
    res = _tool("compare_runs.py", a, b)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    amps = lines.index("scale |          A |          B |    B vs A")
    rates = lines.index("scale |   A it/s |   B it/s |   speedup")
    for k in range(5):
        assert lines[amps + 1 + k].startswith(f"{k:5d} | ")
        assert lines[rates + 1 + k].startswith(f"{k:5d} | ")
        assert lines[rates + 1 + k].endswith("x")
    assert lines[amps + 1].split("|")[1:3] == ["   1.000000 ", "   1.000000 "]
    assert any(ln.startswith(f"eval: A {metric}=") and f"B {metric}=" in ln
               for ln in lines)


def test_analyze_soak_reads_a_port_logbook(runs):
    """Exit 0 and the scale's iterations, sustained rate and no interval
    with non-finite metrics."""
    logbook = os.path.join(runs["video-vae-nb"][1], "logbook.txt")
    res = _tool("analyze_soak.py", logbook, "--scale", "5")
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("scale 5: 1 iters over ")
    assert lines[1].lstrip().startswith("sustained ")
    assert "0 intervals with non-finite metrics" in lines[2]
