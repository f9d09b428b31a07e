"""The share of the traced window in which no kernel, memcpy or memset
ran on the card."""


def read(run):
    if run["kind"] != "sample":
        return None
    return max(100 * (1 - r["trace"]["busy_s"] / r["trace"]["window_s"])
               for r in run["ranks"])
