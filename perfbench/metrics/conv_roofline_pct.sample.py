"""The convolutions' share of their roofline in the traced requests: the
least seconds the requests' forward convolutions take at the card's peak
and memory bandwidth (perfbench/flops, each convolution the larger of its
FLOPs' and its bytes' time) over the device time of the convolution
kernels, cuDNN's layout transforms left out."""


def read(run):
    if run["kind"] != "sample" or not run["roofline_s_per_request"]:
        return None
    conv_s = run["ranks"][0]["trace"]["conv_s"]
    if conv_s <= 0:
        return None
    return 100 * run["roofline_s_per_request"] * run["trace_requests"] \
        / conv_s
