"""Tracing and step timing (the port of the JAX package's
`utils/profiling.py`).

  * trace(dir, device): `torch.profiler` over the block, CPU activity and,
    when the run is on the card, CUDA activity; one Chrome / Perfetto trace
    JSON (`trace.json`) is written into dir. A falsy dir starts no
    profiler. The train CLIs wrap their run in it (`--profile-dir`).
  * barrier(value): wait for everything `value` depends on and return it
    as a host float.
  * StepTimer: steps/s over a window, synchronised through `barrier`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(trace_dir: Optional[str], device=None):
    """A profiler trace of the block into trace_dir/trace.json; a no-op
    when trace_dir is falsy. `device`: the run's; CUDA activity is recorded
    when it is a CUDA device."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_NAME))


def barrier(value) -> float:
    """A scalar of `value` on the host: the device has finished everything
    it depends on."""
    if isinstance(value, torch.Tensor):
        return float(value.detach().reshape(-1)[0])
    return float(value)


class StepTimer:
    """Steps/s over a window, synced via `barrier` on a supplied scalar."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n: int, sync_value=None) -> Optional[float]:
        if sync_value is not None:
            barrier(sync_value)
        self.steps += n
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else None

    def reset(self) -> None:
        self.t0 = time.perf_counter()
        self.steps = 0
