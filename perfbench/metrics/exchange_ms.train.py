"""Device ms a training iteration's compute waits for the gradients'
all-reduce on the mesh: the phases "d.exchange" and "g.exchange", the
most over the ranks. Reads each rank's record's "phases" (as
d_backward_pct.train); None on one card or without them."""


def read(run):
    if run["kind"] != "train" or run["chips"] < 2:
        return None
    values = [r["phases"].get("d.exchange", 0.0) + r["phases"]["g.exchange"]
              for r in run["ranks"]
              if r.get("phases") and "g.exchange" in r["phases"]]
    return max(values) if values else None
