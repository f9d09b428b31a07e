"""One rank of a tiny mesh cell on the CPU (gloo), for the tests:
python -m perfbench.tests.mesh_rank <cell> <rank> <port> <out.json>
[<fault>]. Rank 0 writes the run's result to <out.json>."""

import json
import sys

import torch

from perfbench.tests import faults, tiny


def main(name, rank, port, out, fault=None):
    torch.set_num_threads(1)
    ctx = {"rank": int(rank), "port": int(port)}
    if fault:
        faults.plant(fault, ctx)
    result = tiny.run(torch, tiny.cell(name, steps_per_call=2), **ctx)
    if int(rank) == 0:
        with open(out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
