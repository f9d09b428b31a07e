"""The device trace of a window, and what the per-layer metrics read of it.

`traced(torch)` runs its body under torch.profiler with CPU and CUDA
activity, the window marked by a host span, and `summarize` reduces the
profile to plain numbers: the window's length and the seconds in which
some kernel, memcpy or memset ran (the union of their intervals, so that
overlapping streams count once), device time by operation name, the
convolution kernels' time (without cuDNN's layout transforms, which count
apart), and NCCL's device time and launch counts (by the name patterns of
kernels.json), and the longest idle gaps, each named by the innermost
host operation running across its middle.
"""

from __future__ import annotations

import contextlib
import re
from typing import List, Tuple

from . import common

WINDOW = "perfbench.window"


@contextlib.contextmanager
def traced(torch):
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield holder
        torch.cuda.synchronize()
    holder["prof"] = prof


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(torch, prof) -> dict:
    """Seconds throughout; see the module's docstring."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = [e for e in events if e.name == WINDOW
              and e.device_type == DeviceType.CPU]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    patterns = common.kernel_patterns()
    conv = re.compile("|".join(patterns["convolution"]), re.I)
    layout = re.compile("|".join(patterns["layout"]), re.I)
    nccl = re.compile("|".join(patterns["nccl"]), re.I)
    dev, host = [], []
    by_name, conv_s, layout_s, nccl_s, n_nccl = {}, 0.0, 0.0, 0.0, 0
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the window's own span shows on the device's timeline too
            if e.name == WINDOW or b <= w0 or a >= w1:
                continue
            a, b = max(a, w0), min(b, w1)
            dev.append((a, b))
            s = (b - a) / 1e6
            by_name[e.name] = by_name.get(e.name, 0.0) + s
            if nccl.search(e.name):
                nccl_s += s
                n_nccl += 1
            elif layout.search(e.name):
                layout_s += s
            elif conv.search(e.name):
                conv_s += s
        elif e.name != WINDOW and b > w0 and a < w1:
            host.append((a, b, e.name))
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps, last = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        over = [h for h in host if h[0] <= mid <= h[1]]
        name = min(over, key=lambda h: h[1] - h[0])[2] if over else "(none)"
        named.append([name, (b - a) / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_s,
            "conv_s": conv_s, "layout_s": layout_s, "nccl_s": nccl_s,
            "nccl_launches": n_nccl,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": named}
