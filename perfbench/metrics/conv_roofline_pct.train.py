"""The convolutions' share of their roofline in the traced iterations:
the least seconds the iteration's convolutions take at the card's peak
and memory bandwidth (perfbench/flops, each convolution the larger of its
FLOPs' and its bytes' time, at the global batch) over the device time of
the convolution kernels, summed over the ranks, cuDNN's layout
transforms left out."""


def read(run):
    if run["kind"] != "train" or not run["roofline_s_per_iter"]:
        return None
    conv_s = sum(r["trace"]["conv_s"] for r in run["ranks"])
    if conv_s <= 0:
        return None
    return 100 * run["roofline_s_per_iter"] * run["trace_iters"] / conv_s
