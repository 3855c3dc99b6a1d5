"""Kernels: row 4 (``csrc/encoder_attention.cu``, ``attn_wgmma_kernel``),
its share of the roofline in %: the least time its calls could take
(``work/encoder_attention.py`` over the card's peaks, ``lib/peaks.py``)
over their device time in the traced part of the window.  Every call of a
batch cell is one encoder layer at the cell's batch."""

from gpubench.lib import peaks, spec

KERNEL = "attn_wgmma_kernel"


def read(run):
    if run.trace is None:
        return None
    times = [e - s for name, s, e in run.trace.in_window() if KERNEL in name]
    if not times:
        return None
    d = run.cell.dims
    ops, nbytes = spec.work("encoder_attention").call(
        run.cell.traffic["audios"], d["n_head"], d["n_audio_ctx"], d["n_state"] // d["n_head"])
    return 100.0 * len(times) * peaks.bound_s(ops, nbytes) / (sum(times) / 1e9)
