"""The readings the limits of `correct` are set from, on the card at the
cell's own size. The benchmark's runs never run this.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3
        --variants program,bf16,frozen

For each seed and variant it runs the cell (set-up, the first steps or,
sampling, one request as its window, the comparison with the plain
reference)
and prints one JSON line with the numbers compared. Variants:
  program         the program as the configuration states it (the lower
                  readings);
  bf16            the control: the program's own lower-precision path,
                  --compute-dtype bfloat16 (training), or the plain
                  reference in bfloat16 in the program's place (sampling);
  <fault>         a fault of perfbench/tests/faults.py planted in the
                  program (frozen, half_batch, no_exchange,
                  no_bn_sums, altered_sample).
A cell on several cards runs its ranks here in one process group, which
every seed and variant reuses.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import common  # noqa: E402

# what each fault replaces, put back after its readings
PATCHED = (("hpvaegan_tpu_torch.training.steps", "_set_grads"),
           ("hpvaegan_tpu_torch.parallel.spatial", "_neighbour_rows"),
           ("hpvaegan_tpu_torch.ops.norm", "_group_batch_stats"),
           ("hpvaegan_tpu_torch.parallel.sampling", "_host_copy"))


@contextlib.contextmanager
def variant(name: str, ctx: dict):
    import importlib

    from perfbench.tests import faults

    saved = [(importlib.import_module(m), a) for m, a in PATCHED]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    for key in ("fault", "compute_dtype", "producer"):
        ctx.pop(key, None)
    if name == "bf16":
        ctx["compute_dtype"] = "bfloat16"
        ctx["producer"] = _reference_bf16
    elif name != "program":
        faults.plant(name, ctx)
    try:
        yield
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


def _reference_bf16(weights, cfg, amps, seed, device, n, stages):
    """The sampler's control: the plain reference in bfloat16, in the
    program's place (the program's own sampler does not run in
    bfloat16: its samples reach the host as float32 numpy)."""
    import torch

    from perfbench.reference import hpvaegan as ref

    with ref.plain_math():
        out = ref.sample(weights, cfg, n, amps, seed, device, stages,
                         dtype=torch.bfloat16)
    return out.movedim(1, -1).cpu().numpy()


def readings(torch, cell, seeds, variants, rank=0, port=None):
    """Runs every variant on every seed; returns (and prints) rank 0's
    records."""
    from hpvaegan_tpu_torch.parallel import mesh, multihost
    from hpvaegan_tpu_torch.training import chunk as tchunk
    import torch.distributed as dist

    from perfbench import trace as tr
    from perfbench.kinds import train

    w = cell["work"]
    ranks = w.get("mesh_data", 1) * w.get("mesh_sp", 1)
    device = mesh.select_device("cuda", 0, rank)
    group = mesh.DataGroup()
    if ranks > 1:
        multihost.init_distributed(f"localhost:{port}", ranks, rank,
                                   device=device)
        group = mesh.make_data_group(w["mesh_data"], w["mesh_sp"])
    kind = common.kind(w["kind"])
    found = []
    with mesh.data_parallel(group):
        for seed in seeds:
            for name in variants:
                args = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
                ctx = {"cell": cell, "args": args, "clock": common.Clock(),
                       "device": device, "rank": rank,
                       "readings_only": True}
                t0 = time.perf_counter()
                with variant(name, ctx):
                    if ranks > 1:
                        out = train._run_cell(torch, ctx, cell["cfg"], w,
                                              device, ranks, rank, dist, tr,
                                              tchunk)
                    else:
                        out = kind.run(torch, ctx)
                if rank == 0:
                    found.append({
                        "cell": cell["name"], "seed": seed, "variant": name,
                        "correct": out["correct"], "s": time.perf_counter()
                        - t0, "readings": out["readings"]})
                    print(json.dumps(found[-1]), flush=True)
    if ranks > 1:
        dist.destroy_process_group()
    return found


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    a = p.parse_args(argv)
    common.set_cache_dirs()
    import torch

    cell = common.cell(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    variants = a.variants.split(",")
    ranks = cell["work"].get("mesh_data", 1) * cell["work"].get("mesh_sp", 1)
    if ranks > 1 and a.rank == 0:
        import subprocess

        from perfbench.kinds.train import _free_port

        port = _free_port()
        procs = [subprocess.Popen([sys.executable, "-m", "perfbench.control"]
                                  + argv + ["--rank", str(r), "--port",
                                            str(port)], cwd=ROOT,
                                  stdout=subprocess.DEVNULL)
                 for r in range(1, ranks)]
        try:
            readings(torch, cell, seeds, variants, 0, port)
        finally:
            for proc in procs:
                proc.wait()
        return
    readings(torch, cell, seeds, variants, a.rank, a.port)


if __name__ == "__main__":
    main(sys.argv[1:])
