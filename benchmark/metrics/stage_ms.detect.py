"""Milliseconds a batch on the ingest ring's staging thread: the pinned
copy and the H2D issue (``run_pipeline``'s returned ``h2d_s``)."""


def read(run):
    if not run.layer.get("batches"):
        return None
    return run.layer["stage_s"] / run.layer["batches"] * 1e3
