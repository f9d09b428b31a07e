"""The whole training step's share of the cards' peak: the iteration's
FLOPs (perfbench/flops) times the window's iterations, over its seconds
times the peak times the cards."""


def read(run):
    if run["kind"] != "train" or not run["peak_flops"]:
        return None
    return 100 * run["flops_per_iter"] * run["iters"] / (
        run["elapsed_s"] * run["peak_flops"] * run["chips"])
