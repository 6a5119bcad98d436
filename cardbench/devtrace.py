"""What a ``torch.profiler`` trace of part of the window says.

The harness labels the host's work with ``record_function`` ranges whose
names start with ``cardbench.`` (the traced window, each request, and the
server's ``load_context``, ``assemble`` and ``_decode``). From the trace
this module takes the device's operations (kernels, copies and sets,
clipped to the traced window), their union (``busy_s``), the device
operations that took most time, and the device's idle time split by the
innermost host range that was open at each gap's middle.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

PREFIX = "cardbench."
WINDOW = PREFIX + "window"

# the host range open during an idle gap -> what the host was doing
HOST_LABEL = {
    PREFIX + "load_context": "plan (load_context outside assemble)",
    PREFIX + "assemble": "assemble (Huffman decode, dequant staging)",
    PREFIX + "_decode": "decode loop (_decode)",
    PREFIX + "request": "generate outside load_context and _decode",
}
BETWEEN = "between requests (harness)"
NAME_CHARS = 120     # a device operation's name in the breakdown, cut


def _events(prof):
    """(name, is_device, start_us, end_us) of every event of the trace,
    from the profiler's Kineto results."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        yield (e.name(), e.device_type() == DeviceType.CUDA, s,
               s + e.duration_ns() / 1e3)


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof) -> dict | None:
    """busy_s, window_s, ``kernels`` [(name, seconds)] of every device
    operation in the window, the top device operations and the idle
    time by host activity; None when the trace has no window."""
    window, dev, host, host_names = None, [], [], set()
    for name, is_dev, s, e in _events(prof):
        if is_dev:
            dev.append((name, s, e))
            continue
        host_names.add(name)
        if name == WINDOW:
            window = (s, e)
        elif name in HOST_LABEL:
            host.append((s, e, name))
    if window is None:
        return None
    # a host range's mirror on the device timeline (a GPU user
    # annotation) bears its name and is no device operation
    dev = [d for d in dev if d[0] not in host_names]
    w0, w1 = window
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
               if e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in clipped])
    busy_us = sum(e - s for s, e in busy)
    by_op = defaultdict(float)
    for n, s, e in clipped:
        by_op[n[:NAME_CHARS]] += (e - s) / 1e6
    # idle gaps between the busy spans, and at the window's two ends
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    starts = [s for s, _, _ in host]
    idle = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        inner = None
        for hs, he, name in host[:bisect.bisect_right(starts, mid)]:
            if he >= mid and (inner is None or he - hs < inner[1] - inner[0]):
                inner = (hs, he, name)
        idle[HOST_LABEL[inner[2]] if inner else BETWEEN] += (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "kernels": [(n, (e - s) / 1e6) for n, s, e in clipped],
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(idle)}}
