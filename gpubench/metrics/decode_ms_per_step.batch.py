"""The window on the device (``decode/task.py::DecodeTask`` ->
``decode/loop.py::DecodeWindow``): device ms a decode step, from CUDA
events around each ``run_batch`` call less the encoder's span in it, over
the steps each decode reports it ran (``DecodeResult.steps``).  It counts
the prefill and the host's work in the call too, spread over the steps."""


def read(run):
    calls = [c for c in run.calls if c.call_ms is not None and c.steps]
    if not calls:
        return None
    return sum(c.call_ms - c.encoder_ms for c in calls) / sum(c.steps for c in calls)
