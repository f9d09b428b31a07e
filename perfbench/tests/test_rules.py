"""The harness's own rules, on the CPU: what a run may import, the names
and units of BENCHMARK.json, that each part of a cell is found by its
name alone, and the last line a run prints."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest
import torch

from perfbench import common
from perfbench.tests import tiny

ROOT = common.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = top_level_modules(
        "import json, sys, torch\n"
        "from perfbench import run, common\n"
        "from perfbench.reference import hpvaegan\n"
        "from perfbench.tests import tiny\n"
        "tiny.run(torch, tiny.cell('img-s9-train', steps_per_call=2))\n"
        "tiny.run(torch, tiny.cell('img-sample64', samples=2), seconds=0.1)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "hpvaegan_tpu_torch" in names  # the program ran
    assert not names & set(common.FORBIDDEN), names & set(common.FORBIDDEN)


def test_the_reference_takes_nothing_of_the_program():
    names = top_level_modules(
        "import json, sys\n"
        "from perfbench.reference import hpvaegan\n"
        "from perfbench.flops import hpvaegan as f\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not names & {"hpvaegan_tpu_torch", "hpvaegan_tpu", "jax"}
    for folder in ("reference", "flops"):
        for fn in os.listdir(os.path.join(common.HERE, folder)):
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(common.HERE, folder, fn)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = [a.name for a in getattr(node, "names", [])] \
                    if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) \
                    and not node.level else []
                for m in mods:
                    assert m.split(".")[0] in {"torch", "math", "contextlib",
                                               "typing", "__future__"}, m


def test_names_and_units():
    bench = common.spec()
    names = [c["name"] for c in bench["configs"]] \
        + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]] \
        + [w["config"] for w in bench["workloads"]] \
        + [w["traffic"] for w in bench["workloads"]] \
        + [k for c in bench["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_part_of_every_cell_has_its_file():
    bench = common.spec()
    for w in bench["workloads"]:
        cell = common.cell(w["name"])
        assert common.kind(cell["work"]["kind"]).run
        for m in cell["per_layer"]:
            assert callable(common.reader(m["name"]))
        assert cell["end_to_end"] and cell["per_layer"]


def test_a_new_cell_is_found_by_name(tmp_path, monkeypatch):
    """A configuration, a traffic mix and a metric dropped into their
    folders, with their entries in BENCHMARK.json, need no other edit."""
    here = tmp_path / "perfbench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(common.HERE, sub), here / sub)
    for fn in ("kernels.json", "peaks.json"):
        shutil.copy(os.path.join(common.HERE, fn), here / fn)
    bench = common.spec()
    shutil.copy(here / "configs" / "hpvaegan-image.json",
                here / "configs" / "new-config.json")
    traffic = common.load_json(here / "workloads" / "img-s9-train.json")
    (here / "workloads" / "new-traffic.json").write_text(
        json.dumps(dict(traffic, scale_idx=7)))
    (here / "metrics" / "new.metric.py").write_text(
        "def read(run):\n    return run['iters'] * 2\n")
    bench["configs"].append(dict(bench["configs"][0], name="new-config",
                                 file="perfbench/configs/new-config.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="new-cell",
                                   config="new-config",
                                   traffic="new-traffic"))
    bench["per_layer"].append({"name": "new.metric", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step", "moves": "iters_per_s",
                               "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(common, "HERE", str(here))
    monkeypatch.setattr(common, "ROOT", str(tmp_path))
    cell = common.cell("new-cell")
    assert cell["cfg"]["nfc"] == 64 and cell["work"]["kind"] == "train"
    assert cell["cfg"]["scale_idx"] == 7  # the traffic picks the scale
    assert [m["name"] for m in cell["per_layer"]][-1] == "new.metric"
    assert common.reader("new.metric")({"iters": 21}) == 42


def test_a_vae_scale_stops_before_it_runs():
    c = tiny.cell("img-s9-train")
    c["cfg"]["scale_idx"] = 1  # under the tiny size's vae_levels 2
    with pytest.raises(SystemExit, match="VAE scale"):
        tiny.run(torch, c)


def _last_line(capsys, result):
    common.emit(result)
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def test_the_last_line(capsys):
    result = tiny.run(torch, tiny.cell("img-s9-train", steps_per_call=2))
    line, err = _last_line(capsys, dict(result))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"iters_per_s", "peak_gb", "setup_s"}
    assert err.strip().splitlines()[-1].startswith("check step:")
    traced = dict(result, breakdown={"device_ops": [], "idle_gaps": []})
    line, _ = _last_line(capsys, traced)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]


def test_no_result_after_a_jax_import(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        common.emit({"correct": True, "checks": {}})
    assert capsys.readouterr().out == ""


def test_no_result_without_the_program(tmp_path):
    """Run from a directory that holds only BENCHMARK.json and perfbench/."""
    shutil.copytree(common.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "img-s9-train",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
