"""Multi-process runs on `torch.distributed`.

The port of the JAX package's `parallel/multihost.py`, with its names and
semantics. One process per device (a rank); parameters are replicated on
every rank, and exactly ONE rank (rank 0, the primary) owns file IO:
experiment dirs, checkpoints, logbook, media. The others run the same
computation against a `NullSaver`, whose writes do nothing and whose reads
resolve against the primary's experiment dir (a shared filesystem).

The bootstrap is `init_distributed`: `host:port` with an explicit process
count and id (`init_method="tcp://host:port"`), or "auto", torchrun's
environment (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`,
`LOCAL_RANK`; the counterpart of TPU pod discovery). The backend is NCCL on
the card and gloo on the CPU. NCCL takes one card per rank; two ranks on
one card (a check, not a deployment) run over gloo, which the explicit
`backend` argument selects. Under gloo the collectives take host tensors
(`comm_device`): a CUDA tensor goes through an explicit copy to the host
and back, never a quiet change of backend or device.

Every helper is the identity in a single-process run (no process group),
and runs its collective in any process group, one rank's included (on the
card that is NCCL's own path); every rank must call the same helpers in the
same order: a collective that one rank skips hangs the others.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_TIMEOUT = datetime.timedelta(minutes=30)


def init_distributed(coordinator: str = "auto",
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> None:
    """Join the process group. coordinator "auto": torchrun's environment
    (env://); else `host:port` with `num_processes` and `process_id`.
    backend: "nccl" or "gloo"; by default NCCL for a `device` on the card
    and gloo for the CPU. A rank on the card should select its device
    (parallel/mesh.py::select_device) first."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator == "auto":
        dist.init_process_group(backend, init_method="env://",
                                timeout=_TIMEOUT)
    else:
        if num_processes is None or process_id is None:
            raise ValueError(f"--dist-coordinator {coordinator} needs "
                             "--dist-nprocs and --dist-procid")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=_TIMEOUT)
    logging.info("torch.distributed: rank %d/%d, backend %s",
                 dist.get_rank(), dist.get_world_size(), backend)


def add_dist_flags(parser) -> None:
    """The --dist-* CLI surface, shared by every train/eval driver."""
    parser.add_argument('--dist-coordinator', type=str, default='',
                        help="multi-process bootstrap: 'auto' (torchrun's "
                             'environment) or host:port with --dist-nprocs/'
                             '--dist-procid; rank 0 owns all file IO')
    parser.add_argument('--dist-nprocs', type=int, default=0,
                        help='process count (explicit-coordinator bootstrap)')
    parser.add_argument('--dist-procid', type=int, default=-1,
                        help="this process's id (explicit bootstrap)")


def init_from_cfg(cfg, device="cuda") -> None:
    """Bootstrap from the --dist-* flags if given (no-op otherwise; a
    process count or id without a coordinator is refused)."""
    coordinator = getattr(cfg, "dist_coordinator", "")
    nprocs = getattr(cfg, "dist_nprocs", 0)
    procid = getattr(cfg, "dist_procid", -1)
    if not coordinator:
        for flag, is_set in (("--dist-nprocs", nprocs != 0),
                             ("--dist-procid", procid != -1)):
            if is_set:
                raise ValueError(f"{flag} needs --dist-coordinator "
                                 "(host:port, or auto under torchrun)")
        return
    init_distributed(coordinator, num_processes=nprocs or None,
                     process_id=procid if procid >= 0 else None,
                     device=device)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the single process that owns file IO (and always true in the
    ordinary single-process run)."""
    return process_index() == 0


def comm_device(group=None) -> torch.device:
    """Where the collectives of `group` take their tensors: the current
    card under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync(tag: str = "barrier") -> None:
    """Cross-process barrier (no-op single-process), at run boundaries: the
    primary's last checkpoint write must not race a non-primary's exit, and
    a non-primary must not read a checkpoint before the primary wrote it."""
    if dist.is_initialized():
        dist.barrier()


def to_host(x):
    """Numpy of a tensor or a tuple of tensors. Single-process it is the
    host copy; multi-process each tensor is this rank's rows of a batch
    sharded over every rank in rank order, and every rank gets the whole
    batch. Pass related tensors as ONE tuple: a call is one all_gather of
    one flat buffer. Under gloo the buffer is copied to the host first,
    where gloo gathers it."""
    single = torch.is_tensor(x)
    parts = [x] if single else list(x)
    if not dist.is_initialized():
        out = [p.detach().cpu().numpy() for p in parts]
        return out[0] if single else tuple(out)
    device = comm_device()
    flat = torch.cat([p.detach().reshape(-1) for p in parts]).to(device)
    gathered = [torch.empty_like(flat) for _ in range(process_count())]
    dist.all_gather(gathered, flat)
    sizes = [p.numel() for p in parts]
    per_rank = [g.cpu().split(sizes) for g in gathered]
    out = []
    for i, p in enumerate(parts):
        rows = [r[i].reshape(p.shape) for r in per_rank]
        out.append(torch.cat(rows).to(p.dtype).numpy())
    return out[0] if single else tuple(out)


def _broadcast(values: np.ndarray) -> np.ndarray:
    """The primary's `values` on every rank (one broadcast)."""
    t = torch.from_numpy(np.ascontiguousarray(values)).to(comm_device())
    dist.broadcast(t, 0)
    return t.cpu().numpy()


def agree_float(x: float) -> float:
    """Broadcast the primary's scalar to every process (identity
    single-process): one rank computes a host-side metric (the disk-read
    SIFID) and shares it. Also a barrier."""
    if not dist.is_initialized():
        return float(x)
    return float(_broadcast(np.asarray([x], np.float64))[0])


def agree_seed(seed: Optional[int]) -> Optional[int]:
    """Every rank trains from the primary's seed: the CLI draws a random one
    when --manualSeed is absent, which would differ per process."""
    if not dist.is_initialized():
        return seed
    val = np.asarray([seed if seed is not None else 0], np.int64)
    return int(_broadcast(val)[0])


def agree_minmax(x: float) -> tuple:
    """(min, max) of a per-process scalar over ALL processes (identity
    single-process). Every rank sees every rank's value, so a symmetry
    check (`lo != hi -> raise`) aborts the job on all ranks instead of
    hanging the others at the next collective."""
    if not dist.is_initialized():
        return float(x), float(x)
    t = torch.tensor([float(x)], dtype=torch.float64, device=comm_device())
    vals = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(vals, t)
    vals = torch.cat(vals).cpu()
    return float(vals.min()), float(vals.max())


def broadcast_str(s: str, max_len: int = 4096) -> str:
    """Broadcast a string from the primary in a fixed-width uint8 buffer.
    The primary's true length rides the same broadcast (an 8-byte header),
    so a string longer than max_len raises on EVERY rank; a local check
    would raise on the primary only (the non-primaries pass "") and leave
    the others hung in the collective."""
    if not dist.is_initialized():
        return s
    b = s.encode()[:max_len]
    buf = np.zeros(8 + max_len, np.uint8)
    buf[:8] = np.frombuffer(len(s.encode()).to_bytes(8, "big"), np.uint8)
    buf[8:8 + len(b)] = np.frombuffer(b, np.uint8)
    out = _broadcast(buf)
    primary_len = int.from_bytes(out[:8].tobytes(), "big")
    if primary_len > max_len:
        raise ValueError(
            f"broadcast_str: primary's encoded string is {primary_len} "
            f"bytes > the fixed broadcast buffer ({max_len}); raise max_len")
    return out[8:8 + primary_len].tobytes().decode()


def select_saver(cfg, make_primary):
    """The primary builds the real saver (run-id auto-increment, directory
    creation) and broadcasts its experiment dir, from which the other
    ranks' NullSavers READ (the netD warm start). Writes stay on the
    primary."""
    if not is_multiprocess():
        return make_primary()
    if is_primary():
        saver = make_primary()
        broadcast_str(saver.experiment_dir)
        return saver
    return NullSaver(cfg, experiment_dir=broadcast_str(""))


class NullSaver:
    """utils/saver.py::DataSaver for non-primary ranks: the same surface,
    writes are no-ops, reads resolve against the primary's experiment dir
    (valid on a shared filesystem; without one a read raises
    FileNotFoundError)."""

    image_dir = None

    def __init__(self, cfg=None, experiment_dir: str = ""):
        self.cfg = cfg
        self.experiment_dir = experiment_dir \
            or "<non-primary: no experiment dir>"
        self.eval_dir = os.path.join(self.experiment_dir, "eval") \
            if experiment_dir else self.experiment_dir

    def save_checkpoint(self, tree, filename: str) -> None:
        pass

    def save_inflight(self, scale_idx: int, payload, iteration: int,
                      noise_amps) -> None:
        pass

    def finalize_scale(self, scale_idx: int, noise_amps, g_tree,
                       d_tree=None, rng=None) -> None:
        pass

    def save_image(self, img, filename: str) -> None:
        pass

    def save_json(self, obj, filename: str) -> None:
        pass

    def load_checkpoint(self, filename: str, path: Optional[str] = None):
        from ..utils.saver import load_pytree

        return load_pytree(os.path.join(path or self.experiment_dir,
                                        filename))

    def load_json(self, filename: str, path: Optional[str] = None):
        with open(os.path.join(path or self.experiment_dir, filename)) as f:
            return json.load(f)
