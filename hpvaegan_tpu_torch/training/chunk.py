"""The fused training chunk: k iterations of a scale with no host work
between them.

The port of the JAX package's `training/steps.py::make_train_chunk`
(steps.py:194-253 there), which scans `steps_per_call` iterations (batch
forming, the D step, the G step, or the fused-dg iteration) in one XLA
program and returns the metrics of its last iteration, because host
dispatch was the bottleneck at small scales. PyTorch's counterpart of one
device program per chunk is a CUDA graph of the iteration
(training/steps.py::train_iteration), captured once per scale and replayed
k times per chunk:

  * the first chunk of a scale runs its iterations eagerly on a side
    stream, PyTorch's whole-network capture recipe: they are real
    iterations of the run, and they settle what capture must not do
    itself (the optimizers' lazily made state, cuDNN's algorithm choice,
    the libraries' workspaces);
  * the second chunk captures one iteration on that stream, with the
    NoiseSource's device generator registered with the graph, so that each
    replay advances its Philox offset as the eager iteration would; the
    host does nothing between the replays (no metric is read);
  * `close` releases the graph and its private memory pool at the end of
    the scale, before the next scale grows the model.

A captured iteration must read and write the same tensors on every replay:
the modules' buffers and the optimizers' state are updated in place, the
optimizers keep their step counts on the device (optim.py), `amps` (host
floats) and cfg are constant within a scale, and nothing in it draws from
the host generator (checked after capture) or reads a value to the host
(capture then fails). The gradients `_set_grads` binds to `.grad` live in
the graph's pool: nothing outside the graph reads them.

In a group of ranks whose collectives are NCCL's (parallel/mesh.py, one
card per rank) the chunk is a graph too, the counterpart of the JAX
package's make_train_chunk(..., mesh=mesh): the captured iteration holds
its collectives (the gradients' and metrics' all-reduce, BatchNorm's group
sums, the spatial axis' halo all-gathers), each on NCCL's stream, forked
from and joined to the capture stream. The scale's first chunk runs every
collective of the iteration eagerly, so that each communicator it uses
(WORLD, the data column, the spatial row) exists before the capture. Every
rank decides the mode alike (the device, the backend and cfg are the same
on all) and so captures the same collectives; the capture runs in
thread-local error mode, so that NCCL's watchdog thread may query its
events meanwhile, and the ranks then agree, in one eager all-reduce, that
every capture succeeded before any replays: a rank whose capture failed
raises, and so do the others, instead of replaying collectives that one
rank never joins.

What a chunk reports of its iteration: `collectives_per_iter`, the
collectives one iteration issues by kind (parallel/mesh.py::collectives,
[calls, bytes]), counted while the graph is captured (a replay issues the
same ones and counts none) or over the last eager iteration; and
`phase_ms()`, the device ms of each phase of the last iteration
(training/steps.py::PHASES), when utils/profiling.py was on while the
iteration was captured or ran: a graph captured with it off holds no
event and reports none.

On the CPU, under --split-step and in a gloo group (whose collectives copy
through the host, which a graph cannot record) the chunk runs its k
iterations as an eager loop; the chunk boundaries, and with them the
trainer's logbook, images and inflight checkpoints, are the same. A failed
capture or replay raises; nothing falls back to eager, and an NCCL group
never drops to gloo.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..parallel import mesh
from ..utils import profiling
from .state import ScaleTrainState
from .steps import Metrics, train_iteration

# graph captures and replays, over the process (as K1's `launches`)
captures = 0
replays = 0


def steps_per_call(cfg) -> int:
    """The chunk length of the JAX trainer (trainer.py:158-170 there): 1
    under --split-step, else --steps-per-call cut to [1, niter]."""
    if cfg.split_step:
        return 1
    return max(1, min(int(cfg.steps_per_call), int(cfg.niter)))


def chunk_mode(device_type: str, split_step: bool, backend: Optional[str],
               ranks: int = 1) -> str:
    """How a scale's chunks run, for the log: "graph" (one rank on the
    card), "graph (N NCCL ranks)", or why eagerly: "eager (N gloo ranks)",
    "eager (cpu)", "eager (split-step)". `backend`: the group's, None
    without a group."""
    group = f"{ranks} {'NCCL' if backend == 'nccl' else backend} " \
        f"rank{'' if ranks == 1 else 's'}"
    if backend not in (None, "nccl"):
        return f"eager ({group})"
    if device_type != "cuda":
        return f"eager ({device_type})"
    if split_step:
        return "eager (split-step)"
    return "graph" if backend is None else f"graph ({group})"


class TrainChunk:
    """Scale cfg.scale_idx's iterations of `st` on `data` (data_scale,
    data_zero) at `amps`, in chunks: `run(k)` runs k iterations and
    returns the last one's metrics (device tensors). `mode` is
    `chunk_mode`'s."""

    def __init__(self, cfg, st: ScaleTrainState, data, amps,
                 vae_phase: bool, former: Callable):
        self.cfg, self.st, self.data = cfg, st, data
        self.amps, self.vae_phase, self.former = amps, vae_phase, former
        self.device = next(st.G.parameters()).device
        self.group, ranks = mesh.everyone()
        backend = None if self.group is None \
            else dist.get_backend(self.group)
        self.mode = chunk_mode(self.device.type, cfg.split_step, backend,
                               ranks)
        self.stream: Optional[torch.cuda.Stream] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Metrics] = None
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.collectives_per_iter = {}
        self.phases = None  # the last iteration's phases (utils/profiling)

    def iteration(self) -> Metrics:
        """One iteration, its collectives and phases kept as the chunk's."""
        before, last = mesh.collectives(), profiling.last_phases()
        metrics = train_iteration(self.cfg, self.st, self.data[0],
                                  self.data[1], self.amps, self.vae_phase,
                                  self.former)
        self.collectives_per_iter = _issued(before)
        seq = profiling.last_phases()
        self.phases = seq if seq is not last else None
        return metrics

    def phase_ms(self) -> dict:
        """{phase: device ms} of the last iteration run or replayed, {}
        when none was traced (utils/profiling.py)."""
        return self.phases.ms() if self.phases is not None else {}

    def run(self, k: int) -> Metrics:
        if not self.mode.startswith("graph"):
            for _ in range(k):
                metrics = self.iteration()
            return metrics
        if self.stream is None:
            return self._warm_up(k)
        if self.graph is None:
            self._capture()
        global replays
        try:
            for _ in range(k):
                self.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"scale {self.cfg.scale_idx}: replaying the "
                               f"training iteration's CUDA graph failed: {e}"
                               ) from e
        replays += k
        # the graph's outputs are overwritten by the next replay
        return {name: v.clone() for name, v in self.outputs.items()}

    def _warm_up(self, k: int) -> Metrics:
        """The first chunk, eagerly on the stream that captures next."""
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for _ in range(k):
                metrics = self.iteration()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        return metrics

    def _capture(self) -> None:
        global captures
        scale = self.cfg.scale_idx
        noise = self.st.noise
        host_before = noise.host_gen.get_state()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(noise.gen)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        error, cause = None, None
        before = torch.cuda.current_stream(self.device)
        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="global"
                                  if self.group is None else "thread_local"):
                outputs = self.iteration()
        except RuntimeError as e:
            # a failed capture_end leaves the capture stream current
            torch.cuda.set_stream(before)
            error, cause = ("capturing the training iteration into a CUDA "
                            f"graph failed: {e}"), e
        else:
            torch.cuda.synchronize(self.device)
            if not torch.equal(noise.host_gen.get_state(), host_before):
                error = ("the captured iteration drew from the host "
                         "generator, whose draws a replay would repeat")
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        if self.group is not None and not self._all_captured(error is None):
            error = error or "the capture failed on another rank"
        if error is not None:
            raise RuntimeError(f"scale {scale}: {error}") from cause
        self.graph, self.outputs = graph, outputs
        captures += 1
        logging.info("scale %d: captured the iteration in %.2f s (graph pool "
                     "%.3f GB)", scale, self.capture_s, self.pool_bytes / 1e9)

    def _all_captured(self, ok: bool) -> bool:
        """Whether every rank of the group captured its iteration: one eager
        all-reduce, so that no rank replays collectives that another rank
        never joins."""
        flag = torch.tensor([float(ok)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        return bool(flag.item())

    def close(self) -> None:
        """Release the graph, its pool and the gradients that live there."""
        if self.graph is None:
            return
        torch.cuda.synchronize(self.device)
        for module in (self.st.G, self.st.D):
            for p in module.parameters():
                p.grad = None
        self.outputs = None
        self.graph.reset()
        self.graph = None
        torch.cuda.empty_cache()


def _issued(before: dict) -> dict:
    """The collectives issued since `before` (mesh.collectives()), by
    kind."""
    return {kind: [a - b for a, b in zip(now, before[kind])]
            for kind, now in mesh.collectives().items()}
