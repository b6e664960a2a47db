"""The ``nms_suppress`` kernel's share of its roofline, in %: the least
time of its launches in the traced window (``lib/roofline.nms_bound_s``
on each launch's rows, candidates, slots and the picks its inputs
needed), over their device time from the profiler, per launch."""


def read(run):
    if run.trace is None or not run.layer.get("nms_calls"):
        return None
    launches = run.trace.kernel_count("nms_suppress")
    device_s = run.trace.kernel_s("nms_suppress")
    if not launches or device_s <= 0:
        return None
    bound = run.layer["nms_bound_s"] / run.layer["nms_calls"]
    return 100.0 * bound / (device_s / launches)
