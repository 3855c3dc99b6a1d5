"""Frontend and encoder (``models/whisper.py::AudioEncoder``): device ms a
window, from CUDA events recorded in forward hooks on ``model.encoder``
around every encoder call of the window, over the windows encoded."""


def read(run):
    calls = [c for c in run.calls if c.encoder_ms is not None]
    if not calls:
        return None
    return sum(c.encoder_ms for c in calls) / sum(len(c.outputs) for c in calls)
