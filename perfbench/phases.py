"""The program's own phase spans and collective counters in a training
cell, read as the metrics d_backward_pct.train, optim_ms.train,
exchange_ms.train and collective_mb_per_iter read them, beside the device
trace of the same chunks. The benchmark's runs never run this: their
training kind does not turn the program's spans on before it builds.

    python3 -m perfbench.phases --workload <cell> --seed <n> [--seconds 5]

It turns utils/profiling.py on before the cell is built, so that the
captured iteration holds its phase events, and runs the cell as
`run.py --trace 1` does (the first steps, the window, the traced
chunks). It prints each rank's phase table to standard error and one
JSON line: per rank "phases", the median over the traced chunks of each
phase's device ms (TrainChunk.phase_ms), and "collectives", the
collectives one iteration issues by kind (TrainChunk.
collectives_per_iter); the traced run's device record and breakdown
(rank 0's); and the four metrics. A cell on several cards runs its ranks
here in one process group, as perfbench.control does.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import common  # noqa: E402

METRICS = ("d_backward_pct.train", "optim_ms.train", "exchange_ms.train",
           "collective_mb_per_iter")


def record(chunks, per_iter) -> dict:
    """A rank's record: the median of each phase over the phase tables of
    `chunks`, and the iteration's collectives `per_iter`."""
    names = list(chunks[-1]) if chunks else []
    return {"phases": {k: statistics.median(c[k] for c in chunks)
                       for k in names},
            "collectives": per_iter}


def run_cell(torch, cell, seed, seconds, rank=0, port=None, kind="cuda",
             trace=1) -> dict:
    """The cell's run on device `kind` (cuda, or cpu for the tests, which
    trace nothing: trace 0); returns rank 0's line, {} elsewhere."""
    import torch.distributed as dist

    from hpvaegan_tpu_torch.parallel import mesh, multihost
    from hpvaegan_tpu_torch.training import chunk as tchunk
    from hpvaegan_tpu_torch.utils import profiling

    from perfbench import trace as tr
    from perfbench.kinds import train

    w = cell["work"]
    ranks = w.get("mesh_data", 1) * w.get("mesh_sp", 1)
    device = mesh.select_device(kind, 0, rank)
    group = mesh.DataGroup()
    if ranks > 1:
        multihost.init_distributed(f"localhost:{port}", ranks, rank,
                                   device=device)
        group = mesh.make_data_group(w["mesh_data"], w["mesh_sp"])
    seen, last = [], {}
    run = tchunk.TrainChunk.run

    def recorded(self, k):
        out = run(self, k)
        seen.append(self.phase_ms())
        last["collectives"] = self.collectives_per_iter
        return out

    tchunk.TrainChunk.run = recorded
    profiling.enable(True)
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=trace)
    ctx = {"cell": cell, "args": args, "clock": common.Clock(),
           "device": device, "rank": rank}
    try:
        with mesh.data_parallel(group):
            out = train._run_cell(torch, ctx, cell["cfg"], w, device, ranks,
                                  rank, dist, tr, tchunk)
            traced = w["trace_iterations"] // w["steps_per_call"]
            mine = record(seen[-traced:], last.get("collectives", {}))
            everyone = [mine]
            if ranks > 1:
                everyone = [None] * ranks
                dist.all_gather_object(everyone, mine)
    finally:
        tchunk.TrainChunk.run = run
        profiling.enable(False)
    if ranks > 1:
        dist.destroy_process_group()
    for r, rec in enumerate(everyone):
        common.note(f"rank {r}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in rec["phases"].items())
            + f"; collectives {rec['collectives']}")
    if rank:
        return {}
    view = {"kind": "train", "chips": ranks, "ranks": everyone}
    metrics = {m: common.reader(m)(view) for m in METRICS}
    return {"cell": cell["name"], "seed": seed, "correct": out["correct"],
            "ranks": everyone, "metrics": metrics,
            "trace_iters": traced * w["steps_per_call"],
            "device": out["device"], "breakdown": out.get("breakdown")}


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    a = p.parse_args(argv)
    common.set_cache_dirs()
    import torch

    cell = common.cell(a.workload)
    if cell["work"]["kind"] != "train":
        raise SystemExit("perfbench.phases reads training cells")
    ranks = cell["work"].get("mesh_data", 1) * cell["work"].get("mesh_sp", 1)
    procs, port = [], a.port
    if ranks > 1 and a.rank == 0:
        from perfbench.kinds.train import _free_port

        port = _free_port()
        procs = [subprocess.Popen([sys.executable, "-m", "perfbench.phases"]
                                  + argv + ["--rank", str(r), "--port",
                                            str(port)], cwd=ROOT,
                                  stdout=subprocess.DEVNULL)
                 for r in range(1, ranks)]
    try:
        out = run_cell(torch, cell, a.seed, a.seconds, a.rank, port)
    finally:
        for proc in procs:
            proc.wait()
    if a.rank == 0:
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
