"""The sampler's share of the card's peak: a request's forward FLOPs
(perfbench/flops) times the window's requests, over its seconds times
the peak."""


def read(run):
    if run["kind"] != "sample" or not run["peak_flops"]:
        return None
    return 100 * run["flops_per_request"] * run["requests"] / (
        run["elapsed_s"] * run["peak_flops"])
