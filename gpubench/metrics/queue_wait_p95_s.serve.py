"""Serving engine (``serve.py::ServingEngine``): the 95th percentile over
every request of the window of its wait for a row, from when it was due to
when the engine admitted it (``RequestHandle.started_at``); a request never
admitted counts as waiting for ever."""

from gpubench.lib.cell import percentile


def read(run):
    if not run.requests:
        return None
    waits = [r.started - r.due if r.started is not None else float("inf") for r in run.requests]
    return percentile(waits, 95)
