"""The share of a training iteration's device time in the critic loss's
gradient, the gradient penalty's double backward: the phase "d.backward"
over the sum of all phases (training/steps.py::PHASES, timed by the
program's CUDA events in the captured iteration), the most over the
ranks. Reads each rank's record's "phases" ({phase: device ms}, the median
over the traced chunks of TrainChunk.phase_ms()); None without them."""


def read(run):
    if run["kind"] != "train":
        return None
    shares = [100 * r["phases"]["d.backward"] / sum(r["phases"].values())
              for r in run["ranks"]
              if r.get("phases") and "d.backward" in r["phases"]]
    return max(shares) if shares else None
