"""NCCL's kernels' share of the traced window, the least over the ranks:
its kernels spin while they wait for the other ranks, so the least share
bounds the exchange itself."""


def read(run):
    if run["kind"] != "train" or run["chips"] < 2:
        return None
    if not any(r["trace"]["nccl_launches"] for r in run["ranks"]):
        return None
    return min(100 * r["trace"]["nccl_s"] / r["trace"]["window_s"]
               for r in run["ranks"])
