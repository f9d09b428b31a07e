"""Tracing (the port of the JAX package's `utils/profiling.py`), and the
program's own spans and counters.

  * trace(dir, device): `torch.profiler` over the block, CPU activity and,
    when the run is on the card, CUDA activity; one Chrome / Perfetto trace
    JSON (`trace.json`) is written into dir, holding the spans below. A
    falsy dir starts no profiler. The train CLIs wrap their run in it
    (`--profile-dir`).

The program's spans and counters are off by default. `enable(on)` turns
them on for the process, and they are also on while a torch.profiler
records (`trace` and any other), so that the program's spans sit in every
profiler trace. Off, each call below returns a shared no-op or returns at
once: it makes no profiler event, reads no clock and records no CUDA
event.

  * span(name, **attrs): a host span. A profiler event of `name`, with
    `attrs` as its arguments (shown when the profiler records shapes), on
    the profiler's clock, which the CUDA activity is converted to, so that
    a trace's idle gaps can be named by the span over them; and its
    perf_counter seconds added to `totals()[name]`.
  * phases(device) / phase(name): device phase spans, for code that a CUDA
    graph captures. Inside a `phases` block, consecutive phases share
    their boundaries: each boundary is one timing CUDA event
    (`external=True`) recorded on the current stream, which a capture
    turns into an event-record node that every replay records again, so
    that the phases tile the block: the device work between one phase and
    the next belongs to the next. A name that starts with "." takes the
    step of the phase before it ("d.forward" then ".backward" is
    "d.backward"). `phase_ms()` reads the last block's phases, in device
    ms (after a host sync, or it waits for the block's last event). A
    phase outside a block is its own pair of events. On the CPU the
    boundaries are perf_counter readings.
  * interval(name, device): a device interval that does not tile: its own
    pair of timing CUDA events (perf_counter readings on the CPU) around
    the block, which a capture keeps as phases' are, and which may lie
    inside a phase or overlap others. Inside a `phases` block it belongs
    to the block, and `interval_ms()` reads the last block's intervals,
    summed by name, as `phase_ms()` reads its phases; outside one it is
    summed into the totals alone.
  * count(name, n): adds n to `counters()[name]`.
  * totals(): {name: (count, seconds)} of the spans and of the phases and
    intervals that ran eagerly (a captured block's are read by `phase_ms`
    and `interval_ms`, not summed); counters(); reset() clears both.
Nothing is written out while a run goes: the totals stay in memory and
are read at the end.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

TRACE_NAME = "trace.json"
# eager phase blocks kept for totals() before the oldest is read
_MAX_PENDING = 256

_ON = False
_NULL = contextlib.nullcontext()
_TOTALS: Dict[str, List[float]] = {}  # name -> [count, seconds]
_COUNTERS: Dict[str, int] = {}
_PENDING: List["_Sequence"] = []  # eager blocks not yet in the totals
_OPEN: Optional["_Sequence"] = None  # the phases() block running
_LAST: Optional["_Sequence"] = None  # the last phases() block that ended


def enable(on: bool) -> None:
    """Turn the program's spans and counters on or off for the process."""
    global _ON
    _ON = bool(on)


def enabled() -> bool:
    """Whether spans and counters record: turned on, or a profiler is
    recording."""
    return _ON or torch._C._autograd._profiler_enabled()


def _add(name: str, seconds: float) -> None:
    t = _TOTALS.setdefault(name, [0, 0.0])
    t[0] += 1
    t[1] += seconds


class _Span:
    __slots__ = ("name", "attrs", "event", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        # a profiler event that is not a user annotation, so that the span
        # does not also show on the device's timeline as device time
        self.event = _RecordFunctionFast(self.name, [], self.attrs or None)
        self.event.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.event.__exit__(*exc)
        _add(self.name, seconds)
        return False


def span(name: str, **attrs):
    """A host span of `name` over the block (module docstring)."""
    if not enabled():
        return _NULL
    return _Span(name, attrs)


def count(name: str, n: int) -> None:
    """Add n to the counter `name`."""
    if enabled():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def _mark(device: torch.device):
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        return event
    return time.perf_counter()


def _elapsed_ms(device: torch.device, a, b) -> float:
    if device.type == "cuda":
        return a.elapsed_time(b)
    return 1e3 * (b - a)


class _Sequence:
    """Consecutive phases: names[i] runs from marks[i] to marks[i + 1];
    and the intervals inside the block, (name, start, end) each."""
    __slots__ = ("device", "names", "marks", "captured", "inside",
                 "intervals")

    def __init__(self, device):
        if isinstance(device, torch.Tensor):
            device = device.device
        self.device = torch.device(device)
        self.names: List[str] = []
        self.marks: list = []
        self.captured = self.device.type == "cuda" \
            and torch.cuda.is_current_stream_capturing()
        self.inside = False  # a phase is open
        self.intervals: list = []

    def ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if len(self.marks) != len(self.names) + 1:
            return out
        if self.device.type == "cuda":
            self.marks[-1].synchronize()
        for name, a, b in zip(self.names, self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + _elapsed_ms(self.device, a, b)
        return out

    def interval_ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.intervals and self.device.type == "cuda":
            self.intervals[-1][2].synchronize()
        for name, a, b in self.intervals:
            out[name] = out.get(name, 0.0) + _elapsed_ms(self.device, a, b)
        return out


def _finish(seq: _Sequence) -> None:
    """An ended block, lone phase or lone interval: its eager phases and
    intervals go to the totals when they are read."""
    if seq.captured or not (seq.names or seq.intervals):
        return
    _PENDING.append(seq)
    if len(_PENDING) > _MAX_PENDING:
        _resolve(_PENDING.pop(0))


def _resolve(seq: _Sequence) -> None:
    for name, ms in seq.ms().items():
        _add(name, ms / 1e3)
    for name, ms in seq.interval_ms().items():
        _add(name, ms / 1e3)


class _Phases:
    __slots__ = ("device", "outer")

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        global _OPEN
        self.outer, _OPEN = _OPEN, _Sequence(self.device)
        return self

    def __exit__(self, *exc):
        global _OPEN, _LAST
        seq, _OPEN = _OPEN, self.outer
        if exc[0] is None and (seq.names or seq.intervals):
            _LAST = seq
            _finish(seq)
        return False


def phases(device):
    """A block whose phases tile it, on `device` (or a tensor's; module
    docstring)."""
    if not enabled():
        return _NULL
    return _Phases(device)


class _Phase:
    __slots__ = ("name", "device", "seq")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        seq = _OPEN if _OPEN is not None else _Sequence(self.device)
        if seq.inside:
            raise RuntimeError(f"phase {self.name!r} inside phase "
                               f"{seq.names[-1]!r}: phases do not nest")
        name = self.name
        if name.startswith("."):
            step = seq.names[-1].split(".")[0] if seq.names else ""
            name = step + name
        if not seq.marks:
            seq.marks.append(_mark(seq.device))
        seq.names.append(name)
        seq.inside, self.seq = True, seq
        return self

    def __exit__(self, *exc):
        seq = self.seq
        seq.marks.append(_mark(seq.device))
        seq.inside = False
        if seq is not _OPEN:
            _finish(seq)
        return False


def phase(name: str, device=None):
    """One phase of the phases() block running, or, outside one, a phase
    of its own on `device` (module docstring); nothing outside a block
    without a device (the block began while the spans were off)."""
    if not enabled() or (_OPEN is None and device is None):
        return _NULL
    return _Phase(name, device)


class _Interval:
    __slots__ = ("name", "device", "start")

    def __init__(self, name: str, device):
        if isinstance(device, torch.Tensor):
            device = device.device
        self.name, self.device = name, torch.device(device)

    def __enter__(self):
        self.start = _mark(self.device)
        return self

    def __exit__(self, *exc):
        record = (self.name, self.start, _mark(self.device))
        if _OPEN is not None:
            _OPEN.intervals.append(record)
        else:
            seq = _Sequence(self.device)
            seq.intervals.append(record)
            _finish(seq)
        return False


def interval(name: str, device):
    """A device interval of `name` over the block, on `device` (or a
    tensor's; module docstring)."""
    if not enabled():
        return _NULL
    return _Interval(name, device)


def last_phases() -> Optional[_Sequence]:
    """The last phases() block that ended (a captured one included)."""
    return _LAST


def phase_ms() -> Dict[str, float]:
    """{phase: ms} of the last phases() block: for a captured one, its
    last replay's."""
    return _LAST.ms() if _LAST is not None else {}


def interval_ms() -> Dict[str, float]:
    """{interval: ms} of the last phases() block, each name's intervals
    summed: for a captured block, its last replay's."""
    return _LAST.interval_ms() if _LAST is not None else {}


def totals() -> Dict[str, Tuple[int, float]]:
    """{name: (count, seconds)} of the spans and eager phases so far."""
    while _PENDING:
        _resolve(_PENDING.pop(0))
    return {k: (int(c), s) for k, (c, s) in _TOTALS.items()}


def counters() -> Dict[str, int]:
    return dict(_COUNTERS)


def reset() -> None:
    """Forget the totals, the counters and the last phases."""
    global _LAST
    _TOTALS.clear()
    _COUNTERS.clear()
    _PENDING.clear()
    _LAST = None


@contextlib.contextmanager
def trace(trace_dir: Optional[str], device=None):
    """A profiler trace of the block into trace_dir/trace.json, with the
    program's spans on for the block; a no-op when trace_dir is falsy.
    `device`: the run's; CUDA activity is recorded when it is a CUDA
    device."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    before = _ON
    enable(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        enable(before)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_NAME))
