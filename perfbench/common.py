"""What every cell shares: the files the harness finds by name, the cache
directories, the device record, the rules on what a run may import, and
the last line a run prints.

A cell is one entry of BENCHMARK.json's `workloads`. Its configuration is
`configs/<config>.json`, its traffic `workloads/<traffic>.json` (whose
"kind" names the module `kinds/<kind>.py` that runs it, whose "limits"
are the limits of the numbers that decide `correct`, and which may pick
the scale the cell runs, `scale_idx`, in place of the configuration's),
and each per-layer metric is read by `metrics/<metric>.py`. Adding any
of these is adding a file.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".perfbench_cache")
# the JAX package and JAX itself, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "hpvaegan_tpu")
# keys of a configuration that a traffic file may set for its cell
SCALE_KEYS = ("scale_idx",)


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program at a fixed place inside
    the checkout; call before torch is imported."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration ("cfg")
    and traffic ("work") read from their files."""
    bench = spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = dict(cells[name])
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    w["cfg"] = load_json(os.path.join(ROOT, conf["file"]))
    w["work"] = load_json(os.path.join(HERE, "workloads",
                                       f"{w['traffic']}.json"))
    for key in SCALE_KEYS:  # the traffic picks the scale it runs
        if key in w["work"]:
            w["cfg"][key] = w["work"][key]
    w["end_to_end"] = [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])]
    w["per_layer"] = [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])]
    return w


def kind(name: str):
    """The module kinds/<name>.py that runs a kind of cell."""
    return importlib.import_module(f"perfbench.kinds.{name}")


def reader(metric: str):
    """The `read(run)` function of metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    mod_name = "perfbench_metric_" + metric.replace(".", "_").replace("-", "_")
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list:
    """The top-level names in sys.modules that a run may not load, compared
    whole (hpvaegan_tpu_torch is not hpvaegan_tpu)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _peaks(device_name: str) -> Optional[dict]:
    table = load_json(os.path.join(HERE, "peaks.json"))
    for key, row in table.items():
        if key in device_name:
            return row
    return None


def peak_flops(device_name: str, tf32: bool) -> Optional[float]:
    """The card's published dense peak for float32 convolutions: TF32's
    where cuDNN may use it, else plain float32's; None for a card the
    table does not hold."""
    row = _peaks(device_name)
    return None if row is None else row["tf32" if tf32 else "fp32"]


def peak_bandwidth(device_name: str) -> Optional[float]:
    """The card's published memory bandwidth, bytes a second."""
    row = _peaks(device_name)
    return None if row is None else row["hbm_bytes_per_s"]


def kernel_patterns() -> dict:
    return load_json(os.path.join(HERE, "kernels.json"))


def on_card(device) -> bool:
    return device.type == "cuda"


def sync(torch, device) -> None:
    if on_card(device):
        torch.cuda.synchronize(device)


def peak_bytes(torch, device) -> int:
    """The most the caching allocator has reserved on `device`, the graphs'
    private pools included (0 off the card)."""
    return torch.cuda.max_memory_reserved(device) if on_card(device) else 0


def device_name(torch, device) -> str:
    return torch.cuda.get_device_name(device) if on_card(device) else "cpu"


def device_record(torch, device, count: int, peak: int) -> dict:
    return {"platform": "gpu" if on_card(device) else "cpu",
            "kind": device_name(torch, device), "count": count,
            "memory_peak_bytes": int(peak)}


def require_cards(torch, chips: int) -> None:
    """Exit without a result unless this machine has `chips` cards."""
    if not torch.cuda.is_available():
        raise SystemExit("perfbench: no CUDA device; the benchmark runs on "
                         "the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"perfbench: the cell needs {chips} cards, this "
                         f"machine has {torch.cuda.device_count()}")


def emit(result: dict) -> None:
    """Print the numbers compared as the last lines of standard error and
    the result as the last line of standard output. Refuses to print a
    result when the JAX package or JAX is loaded."""
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"perfbench: the run loaded {bad}; the benchmark "
                         "measures the PyTorch port alone")
    result.pop("readings", None)
    checks = result.pop("checks")
    result["checks"] = checks  # the last key of the line
    sys.stdout.flush()
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def note(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


class Clock:
    """Seconds since the process started its run."""

    def __init__(self, t0: Optional[float] = None):
        self.t0 = time.perf_counter() if t0 is None else t0

    def __call__(self) -> float:
        return time.perf_counter() - self.t0
