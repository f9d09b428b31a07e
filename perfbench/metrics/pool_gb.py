"""The graph's private memory pool (training/chunk.py,
TrainChunk.pool_bytes), the most over the ranks."""


def read(run):
    if run["kind"] != "train":
        return None
    values = [r["pool_bytes"] for r in run["ranks"]]
    return max(values) / 1e9 if any(values) else None
