"""NCCL kernel launches per traced iteration on rank 0: the collectives an
iteration issues (gradient all-reduce, BatchNorm's group sums, halo
exchanges)."""


def read(run):
    if run["kind"] != "train" or run["chips"] < 2:
        return None
    n = run["ranks"][0]["trace"]["nccl_launches"]
    return n / run["trace_iters"] if n else None
