"""Seconds the training chunk took to capture its iteration as a CUDA
graph (training/chunk.py, TrainChunk.capture_s), the most over the
ranks."""


def read(run):
    if run["kind"] != "train":
        return None
    values = [r["capture_s"] for r in run["ranks"]]
    return max(values) if any(values) else None
