"""The whole window: model operations of its calls
(``work/whisper_window.py``, from shapes and the steps each decode reports)
over the calls' time on the host's clock, over the card's bf16 peak
(``lib/peaks.py``), in %."""

from gpubench.lib import peaks, spec


def read(run):
    calls = [c for c in run.calls if c.steps is not None]
    if not calls or run.device.type != "cuda":
        return None
    tr = run.cell.traffic
    group = tr["beam"] if tr["mode"] == "beam" else 1
    w = spec.work("whisper_window")
    ops = sum(w.call_flops(run.cell.dims, run.prefix_lengths[c.batch], group, c.steps)
              for c in calls)
    return 100.0 * ops / sum(c.seconds for c in calls) / peaks.BF16_FLOPS
