"""The traced window: torch.profiler over the CPU and the card, reduced to
what the per-layer metrics and the breakdown read.

Device operations are the trace's events on the card (kernels, copies
and fills); kernels are those that are not copies or fills.  The device
is busy over the union of the operations' intervals; an idle gap is a
stretch of the window in which none ran, named by what the host was
doing at its middle (the innermost host event there, with its parent).
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW = "perfbench.window"
_NOT_KERNEL = ("Memcpy", "Memset", "memcpy", "memset")


def short_name(name: str) -> str:
    """A device operation's name without its return type, template
    arguments, anonymous namespaces and parameter list
    ("void sgd::(anonymous namespace)::head_step_resident<...>(HeadArgs)"
    -> "sgd::head_step_resident")."""
    if name.startswith(_NOT_KERNEL):
        return name.split("(", 1)[0].strip()
    prev = None
    while prev != name:
        prev, name = name, re.sub(r"<[^<>]*>", "", name)
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0].strip()
    return name.split()[-1] if name else prev


@dataclass
class Summary:
    """The traced window: device operations (name, start, end in seconds
    on the trace's clock), the window's span on that clock, and idle gaps
    by host activity."""

    ops: list
    window: tuple
    gaps: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, self.window[0]
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, end), min(e, self.window[1])
            if e > s:
                busy += e - s
                end = e
        return busy

    def kernels(self) -> list:
        return [o for o in self.ops if not o[0].startswith(_NOT_KERNEL)]

    def device_seconds(self, names) -> float:
        """Summed device time of the kernels whose name holds one of `names`."""
        return sum(e - s for n, s, e in self.kernels() if any(k in n for k in names))

    def breakdown(self, top: int = 10) -> dict:
        by_op = defaultdict(float)
        for n, s, e in self.ops:
            by_op[short_name(n)] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": [[n, t] for n, t in gaps]}


@contextlib.contextmanager
def traced(device):
    """Profile the block (CPU and CUDA activity) inside a `perfbench.window`
    span; yields a dict that holds the Summary under "summary" on exit."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        with record_function(WINDOW):
            yield out
            torch.cuda.synchronize(device)
    out["summary"] = summarize(prof.profiler.kineto_results.events())


def summarize(events) -> Summary:
    """The Summary of a profile's kineto events."""
    ops, host, window = [], [], None
    for ev in events:
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not (ev.is_user_annotation() or ev.name() == WINDOW):  # a span's image on the card is no work
                ops.append((ev.name(), s, e))
        elif ev.name() == WINDOW:
            window = (s, e)
        else:
            host.append((s, e, ev.name()))
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW} span")
    host.sort()
    return Summary(ops, window, _gaps(ops, host, window))


def _gaps(ops, host, window) -> dict:
    """Idle seconds of the window by what the host was doing."""
    starts = [h[0] for h in host]
    out = defaultdict(float)
    t = window[0]
    for _, s, e in sorted(ops, key=lambda o: o[1]) + [("", window[1], window[1])]:
        if s > t:
            out[_host_at(host, starts, 0.5 * (t + s))] += min(s, window[1]) - t
        t = max(t, e)
    return dict(out)


def _host_at(host, starts, m, reach: int = 256) -> str:
    """The innermost host event holding the time m, with its parent's name."""
    held = []
    for j in range(bisect.bisect_right(starts, m) - 1, max(-1, bisect.bisect_right(starts, m) - 1 - reach), -1):
        if host[j][1] >= m:
            held.append(host[j][2])
            if len(held) == 2:
                break
    if not held:
        return "python, outside any torch op"
    return held[0] if len(held) < 2 else f"{held[1]} > {held[0]}"
