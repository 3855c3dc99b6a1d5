"""Reading a ``torch.profiler`` run: the device's activity, the host's
annotations, and what the result line's ``device`` and ``breakdown`` carry.

The raw Kineto events are read directly (``kineto_results.events()``), as
``chip_smoke.py::device_events`` reads them, without building the
profiler's tree of every event.  Device and host events share one clock
there.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, int, int]]  # (name, start ns, end ns), by start
    host: List[Tuple[str, int, int]]  # host operators and annotations, by start
    window: Tuple[int, int]  # the traced interval (ns), from the harness's own spans

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def in_window(self) -> List[Tuple[str, int, int]]:
        a, b = self.window
        return [(n, max(s, a), min(e, b)) for n, s, e in self.device if e > a and s < b]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The traced interval's device activity as disjoint intervals."""
        merged: List[List[int]] = []
        for _, s, e in sorted(self.in_window(), key=lambda t: t[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_ops(self, top: int = 10) -> List[list]:
        """[[kernel or copy name, device seconds]] of the ``top`` names that
        took most time in the traced interval."""
        by: Dict[str, int] = {}
        for n, s, e in self.in_window():
            by[n] = by.get(n, 0) + (e - s)
        return [[n[:120], t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """[[what the host was doing, idle seconds]]: the device's idle time
        in the traced interval, summed by the innermost host event (the one
        that started last) under the middle of each gap, the ``top``
        largest."""
        a, b = self.window
        edges = [a]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(b)
        starts = [h[1] for h in self.host]
        by: Dict[str, int] = {}
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) // 2
            label = "no host event"
            for i in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(
                    starts, mid) - 2000), -1):
                name, hs, he = self.host[i]
                if hs <= mid < he:
                    label = name
                    break
            by[label] = by.get(label, 0) + (e - s)
        return [[n[:120], t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def read(prof, span: str) -> Optional[Trace]:
    """The Trace of a finished profiler run whose traced interval runs from
    the first start to the last end of the host annotations named
    ``span``; None where it holds no device activity or no such span."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    names: Dict[str, str] = {}
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        raw = e.name()
        name = names.get(raw)
        if name is None:
            name = names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        if e.device_type() == cuda:
            # the host's annotations are mirrored on the device's timeline: not device work
            if (name in (span, "Activity Buffer Request") or name.startswith("ProfilerStep")
                    or e.is_async()):
                continue
            device.append((name, e.start_ns(), e.end_ns()))
        elif e.device_type() == cpu:
            host.append((name, e.start_ns(), e.end_ns()))
    spans = [(s, e) for n, s, e in host if n == span]
    if not device or not spans:
        return None
    device.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return Trace(device, host, (min(s for s, _ in spans), max(e for _, e in spans)))
