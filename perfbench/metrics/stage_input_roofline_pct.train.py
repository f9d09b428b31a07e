"""The stage inputs' share of their memory roofline: the least bytes
making them moves an iteration (the program's counter
"stage_input_bytes": each previous stage's output read once and each
padded stage input written once, from their shapes), over the card's
memory bandwidth (perfbench/peaks.json), over the device seconds of the
interval "stage_input" an iteration (as stage_input_pct.train reads it).
None without them."""


def read(run):
    if run["kind"] != "train" or not run.get("peak_bytes_per_s"):
        return None
    shares = [100 * r["stage_input_bytes_per_iter"] / run["peak_bytes_per_s"]
              / (r["intervals"]["stage_input"] / 1e3)
              for r in run["ranks"]
              if r.get("stage_input_bytes_per_iter")
              and r.get("intervals", {}).get("stage_input")]
    return max(shares) if shares else None
