"""Device ms a training iteration spends in its optimizers: the phases
"d.optim" and "g.optim" (Adam's steps and the spectral-norm state), the
most over the ranks. Reads each rank's record's "phases" (as
d_backward_pct.train); None without them."""


def read(run):
    if run["kind"] != "train":
        return None
    values = [r["phases"].get("d.optim", 0.0) + r["phases"]["g.optim"]
              for r in run["ranks"]
              if r.get("phases") and "g.optim" in r["phases"]]
    return max(values) if values else None
