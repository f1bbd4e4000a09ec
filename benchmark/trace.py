"""The device trace of a window: ``torch.profiler`` (host and CUDA activity),
read into what the per-layer metrics and the ``breakdown`` take.

``busy_s`` is the union of the device's activity intervals (kernels, copies,
sets) inside the window, ``window_s`` the window's length, both from the
trace's clock; kernel time by name is each kernel's summed duration inside the
window. An idle gap is named by the innermost host span (an operator, a
runtime call or one of the benchmark's own ``bench.*`` spans) that covers its
start.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re

WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict  # device activity name -> seconds inside the window
    gaps: list  # [(host activity, seconds)], longest first

    def seconds_of(self, patterns) -> float:
        """Summed seconds of the device activities whose name holds any of ``patterns``."""
        return sum(s for name, s in self.kernel_s.items() if any(p in name for p in patterns))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[short_name(n), s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:top]]}


def short_name(name: str) -> str:
    """A kernel's name without its return type and its parameter list."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out and out[-1] != " ":
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:160]


@contextlib.contextmanager
def profiled(enabled: bool):
    """Profile the block (CPU and CUDA activity) when ``enabled``; yields the
    profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def _side(ev) -> str:
    """``host``, ``device`` (an activity of the device) or ``mirror`` (the
    device-side copy of a host annotation such as the ``bench.*`` spans)."""
    if str(ev.device_type()).rsplit(".", 1)[-1].upper() == "CPU":
        return "host"
    annotation = getattr(ev, "is_user_annotation", lambda: False)()
    return "mirror" if annotation or ev.name().startswith("bench.") else "device"


def read(prof, top_gaps: int = 10) -> Trace:
    """The window's :class:`Trace` from a finished profiler; the ``top_gaps``
    longest idle gaps are named."""
    events = prof.profiler.kineto_results.events()
    host, device, window = [], [], None
    for ev in events:
        start, dur, side = ev.start_ns(), ev.duration_ns(), _side(ev)
        if side == "device":
            device.append((start, start + dur, ev.name()))
        elif side == "host":
            if ev.name() == WINDOW:
                window = (start, start + dur)
            host.append((start, start + dur, ev.name()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    lo, hi = window
    kernel_s: dict = {}
    spans = []
    for s, e, name in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-9
        spans.append((s, e))
    spans.sort()
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9
    edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top_gaps]
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for s, e in gaps:
        best = None
        i = bisect.bisect_right(starts, s)
        for j in range(i - 1, max(-1, i - 4000), -1):
            hs, he, name = host[j]
            if he > s and name != WINDOW and (best is None or he - hs < best[1] - best[0]):
                best = (hs, he, name)
        named.append(((best[2] if best else "host idle"), (e - s) * 1e-9))
    named.sort(key=lambda g: -g[1])
    return Trace((hi - lo) * 1e-9, busy, kernel_s, named)
