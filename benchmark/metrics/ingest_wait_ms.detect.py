"""Milliseconds a batch that ``run_pipeline`` waited in ``next()`` on the
prefetcher (the benchmark's span ``ingest_wait`` around each call)."""


def read(run):
    if run.spans is None:
        return None
    return run.spans.ms_per("ingest_wait", run.layer["batches"])
