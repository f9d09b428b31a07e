"""The launcher of the tests that run on several ranks: a test module runs
itself as a script, one process per rank (`run_ranks`), and its
`__main__` hands the rank to `worker_main`, which runs the named case and
saves its result for the test to compare."""

import os
import socket
import subprocess
import sys
import tempfile
import time

import torch


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(script: str, case: str, out_dir, *args, world: int = 2,
              timeout: int = 300):
    """Run `script` as `script case rank world port out_dir *args` once per
    rank, concurrently; returns each rank's <out_dir>/<case>_<rank>.pt.
    A rank that fails ends the others (they would wait for it). free_port's
    port can be taken by another process before rank 0 binds it: the ranks
    then run again on a new port, twice at most."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    for attempt in range(3):
        port = free_port()
        logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, script, case, str(r), str(world), str(port),
             str(out_dir), *map(str, args)],
            stdout=log, stderr=subprocess.STDOUT, env=env, text=True)
            for r, log in enumerate(logs)]
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) \
                and not any(p.poll() for p in procs):
            if time.monotonic() > deadline:
                for p in procs:
                    p.kill()
                raise TimeoutError(f"{case}: the ranks ran past {timeout} s")
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
        if attempt < 2 and any("EADDRINUSE" in out for out in outs):
            continue
        break
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [torch.load(os.path.join(str(out_dir), f"{case}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def worker_main(cases) -> None:
    """A rank of run_ranks: join the gloo group on the CPU (unless the case
    `joins_itself`, from the port in its `.port`), run cases[case](rank,
    world, out_dir, *args) and save its result."""
    from hpvaegan_tpu_torch.parallel import multihost

    case, rank, world, port, out_dir = sys.argv[1:6]
    rank, world, fn = int(rank), int(world), cases[case]
    fn.port = port
    if not getattr(fn, "joins_itself", False):
        multihost.init_distributed(f"127.0.0.1:{port}", world, rank,
                                   backend="gloo", device="cpu")
    result = fn(rank, world, out_dir, *sys.argv[6:])
    torch.save(result, os.path.join(out_dir, f"{case}_{rank}.pt"))
    multihost.sync()
