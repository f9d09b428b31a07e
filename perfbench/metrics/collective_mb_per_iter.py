"""MB rank 0 hands to the mesh's collectives in one iteration, summed over
their kinds (gradients, metrics, BatchNorm sums, spatial exchanges), as
the program counts them where it issues them (parallel/mesh.py::
collectives, taken over the captured iteration: TrainChunk.
collectives_per_iter). Reads rank 0's record's "collectives" ({kind:
[calls, bytes]}); None on one card or without it."""


def read(run):
    if run["kind"] != "train" or run["chips"] < 2:
        return None
    found = run["ranks"][0].get("collectives")
    if not found:
        return None
    return sum(n for _, n in found.values()) / 1e6
