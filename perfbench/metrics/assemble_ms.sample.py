"""Host milliseconds a traced request spends joining its samples on the
host after the copy: the program's span "sample.assemble"
(evaluation.generate_samples, utils/profiling.py), recorded while the
trace's profiler runs, per request. None where the program has no such
span."""


def read(run):
    if run["kind"] != "sample":
        return None
    try:
        from hpvaegan_tpu_torch.utils import profiling

        span = profiling.totals().get("sample.assemble")
    except (ImportError, AttributeError):
        return None
    if not span or not span[0]:
        return None
    return 1e3 * span[1] / span[0]
