"""Device: the share of the traced part of the window (a slice of
``lib/cell.py::TRACE_SLICE_S`` seconds at the window's end) in
which no kernel, copy or set ran on the card, from the profiler's
timeline, in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
