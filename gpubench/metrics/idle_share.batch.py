"""Device: the share of the traced part of the window (the host
annotations around the traced calls) in which no kernel, copy or set ran
on the card, from the profiler's timeline, in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
