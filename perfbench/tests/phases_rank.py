"""One rank of perfbench/phases.py on a tiny mesh cell on the CPU (gloo),
for the tests: python -m perfbench.tests.phases_rank <cell> <rank> <port>
<out.json>. Rank 0 writes its line to <out.json>."""

import json
import sys

import torch

from perfbench import phases
from perfbench.tests import tiny


def main(name, rank, port, out):
    torch.set_num_threads(1)
    result = phases.run_cell(torch, tiny.cell(name, steps_per_call=2), 3,
                             0.0, int(rank), int(port), kind="cpu", trace=0)
    if int(rank) == 0:
        with open(out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
