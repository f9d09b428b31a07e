"""The rate of the sampler's copy of its samples to the host in the
traced requests, GB/s: the bytes the program counted onto the host
(counter "d2h_bytes", parallel/sampling.py::_host_copy) over the device
seconds of its "d2h" phase (utils/profiling.py), which the program
records while the trace's profiler runs. None where the program keeps no
such counter."""


def read(run):
    if run["kind"] != "sample":
        return None
    try:
        from hpvaegan_tpu_torch.utils import profiling

        copied = profiling.counters().get("d2h_bytes")
        phase = profiling.totals().get("d2h")
    except (ImportError, AttributeError):
        return None
    if not copied or not phase or phase[1] <= 0:
        return None
    return copied / phase[1] / 1e9
