"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer metrics and the breakdown read.

Events are (name, kind, start_ns, end_ns): ``kind`` is ``"device"`` for
an operation on the card (kernel, copy, set) and ``"span"`` for a host
annotation (``record_function``: the port's own spans and the
benchmark's). A traced slice of the window that records host spans has
the span ``WINDOW``; one that records the device alone has none.
"""
from __future__ import annotations

import bisect

WINDOW = "portbench.window"
TOP = 10


def kineto_events(prof) -> list[tuple]:
    """The events of a finished ``torch.profiler.profile``, read from its
    raw results (no per-event Python objects are built)."""
    from torch.autograd import DeviceType
    out, spans = [], set()
    raw = prof.profiler.kineto_results.events()
    for e in raw:
        if e.device_type() == DeviceType.CPU and e.is_user_annotation():
            spans.add(e.name())
            out.append((e.name(), "span", e.start_ns(), e.end_ns()))
    for e in raw:
        if (e.device_type() != DeviceType.CPU and not e.is_user_annotation()
                and e.name() not in spans):
            out.append((e.name(), "device", e.start_ns(), e.end_ns()))
    return out


def short_name(name: str) -> str:
    """A device operation's name without its template and call arguments
    (``void ns::kernel<8, false>(Args)`` -> ``ns::kernel``); copies and
    sets keep theirs."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    bare = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    cut = min((i for i in (bare.find("<"), bare.find("(")) if i > 0),
              default=len(bare))
    return bare[:cut].strip() or name


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events: list[tuple], window_s: float | None = None) -> dict:
    """Busy and window seconds, device seconds and launches by operation
    name, the top operations (by short name), and the idle gaps summed by
    the innermost host span open at each gap's middle ("(none)" outside
    every span). The window is the ``WINDOW`` span; a trace of the device
    alone has none, and its window is ``window_s`` seconds from its first
    device operation's start."""
    win = [(a, b) for name, kind, a, b in events
           if kind == "span" and name == WINDOW]
    if win:
        w0, w1 = win[0]
    else:
        starts = [a for _name, kind, a, _b in events if kind == "device"]
        if window_s is None or not starts:
            raise ValueError(f"the trace holds no {WINDOW!r} span")
        w0 = min(starts)
        w1 = w0 + int(round(window_s * 1e9))
    by_name: dict = {}
    clipped = []
    for name, kind, a, b in events:
        if kind != "device" or b <= w0 or a >= w1:
            continue
        a, b = max(a, w0), min(b, w1)
        clipped.append((a, b))
        tot = by_name.setdefault(name, [0, 0])
        tot[0] += b - a
        tot[1] += 1
    busy = _union(clipped)
    busy_ns = sum(b - a for a, b in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = sorted((a, b, name) for name, kind, a, b in events
                   if kind == "span" and name != WINDOW)
    starts = [s[0] for s in spans]
    longest = max((b - a for a, b, _ in spans), default=0)
    idle: dict = {}
    for a, b in gaps:
        mid = (a + b) // 2
        # innermost open span: the latest-started one still open at mid
        inner = "(none)"
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if spans[j][1] >= mid:
                inner = spans[j][2]
                break
            if mid - spans[j][0] > longest:
                break
        idle[inner] = idle.get(inner, 0) + (b - a)
    short: dict = {}
    for name, (ns, _n) in by_name.items():
        key = short_name(name)
        short[key] = short.get(key, 0) + ns
    ops = sorted(short.items(), key=lambda kv: -kv[1])
    return dict(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        ops={name: (ns / 1e9, n) for name, (ns, n) in by_name.items()},
        device_ops=[[name, ns / 1e9] for name, ns in ops[:TOP]],
        idle_gaps=[[name, ns / 1e9] for name, ns in sorted(
            idle.items(), key=lambda kv: -kv[1])[:TOP]])


def kernel_seconds(profile: dict, part: str) -> tuple[float, int]:
    """Device seconds and launches of the operations whose name holds
    ``part``."""
    secs = n = 0
    for name, (s, c) in profile["ops"].items():
        if part in name:
            secs += s
            n += c
    return secs, n
