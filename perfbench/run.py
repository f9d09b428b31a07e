"""Runs one cell of BENCHMARK.json once on this machine's cards and prints
its result as the last line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

With --trace 0 the result holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from a profiled stretch after the
window. Everything the cell is made of is found by name (see common.py):
this file holds nothing of any one cell. A cell on several cards starts
its other ranks itself (kinds/train.py); they run this file with --rank
and --port and print nothing. The run exits with an error, and prints no
result, without the cards the cell asks for, or where the JAX package or
JAX has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import common  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv) -> int:
    args = parse(argv)
    common.set_cache_dirs()
    cell = common.cell(args.workload)
    import torch

    common.require_cards(torch, cell["chips"])
    ctx = {"cell": cell, "args": args, "clock": common.Clock(T0),
           "rank": args.rank, "argv": list(argv),
           "device": torch.device("cuda", 0)}
    if args.rank:
        ctx["port"] = args.port
    result = common.kind(cell["work"]["kind"]).run(torch, ctx)
    if args.rank == 0:
        common.emit(result)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        sys.exit(1)
