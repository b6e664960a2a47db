"""Milliseconds a batch in ``DetectStep.__call__``, which returns once the
step's work is queued (the benchmark's span ``issue`` around each call)."""


def read(run):
    if run.spans is None:
        return None
    return run.spans.ms_per("issue", run.layer["batches"])
