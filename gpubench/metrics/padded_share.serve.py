"""Serving engine: the share of the rows of the window's decode calls that
were padding (``stats()``: every call is padded to ``batch_size`` rows),
in %."""


def read(run):
    rows = run.engine_counts.get("rows", 0)
    if not rows:
        return None
    return 100.0 * (rows - run.engine_counts["windows_decoded"]) / rows
