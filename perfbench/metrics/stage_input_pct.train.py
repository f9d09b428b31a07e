"""The share of a training iteration's device time in making the baseline
generator's stage inputs: the program's interval "stage_input" (models/
networks_3d.py::_Baseline, everything before a stage's first
convolution, summed over the iteration's forwards) over the sum of the
iteration's phases (training/steps.py::PHASES), both CUDA events that the
captured iteration records at every replay, the median over the traced
chunks (kinds/train_baseline.py). None without them."""


def read(run):
    if run["kind"] != "train":
        return None
    shares = [100 * r["intervals"]["stage_input"] / sum(r["phases"].values())
              for r in run["ranks"]
              if r.get("phases") and "stage_input" in r.get("intervals", {})]
    return max(shares) if shares else None
