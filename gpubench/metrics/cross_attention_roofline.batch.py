"""Kernels: row 5 (``csrc/cross_attention.cu``, ``cross_attn_kernel``), its
share of the roofline in %: the least time its calls could take
(``work/cross_attention.py`` over the card's peaks, ``lib/peaks.py``) over
their device time in the traced part of the window.  Every call of a batch
cell is one decoder layer of one step, over the cell's audios and their
beams."""

from gpubench.lib import peaks, spec

KERNEL = "cross_attn_kernel"


def read(run):
    if run.trace is None:
        return None
    times = [e - s for name, s, e in run.trace.in_window() if KERNEL in name]
    if not times:
        return None
    d, tr = run.cell.dims, run.cell.traffic
    group = tr["beam"] if tr["mode"] == "beam" else 1
    ops, nbytes = spec.work("cross_attention").call(
        tr["audios"], group, d["n_head"], d["n_state"] // d["n_head"], d["n_audio_ctx"])
    return 100.0 * len(times) * peaks.bound_s(ops, nbytes) / (sum(times) / 1e9)
