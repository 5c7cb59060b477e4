"""What a traced run's profiler recorded: the device's busy time over the
profiled part of the window, the time of each device operation by name,
and the idle gaps, each named by what the host was doing then.

The device's operations are the profiler's CUDA events (kernels, copies
and sets, those of replayed CUDA graphs included). The window is the
harness's ``portbench.profiled`` span. A gap is named by the harness span
around it (``portbench.round``, ``portbench.clients``, ``portbench.idle``)
and by the innermost host operation under its midpoint, if any.
"""

from __future__ import annotations

import dataclasses

NAME_CHARS = 96  # device op names are cut to this many characters
HARNESS = ("portbench.round", "portbench.clients", "portbench.idle")


@dataclasses.dataclass
class Event:
    name: str
    start: int  # ns
    end: int
    device: bool


@dataclasses.dataclass
class TraceSummary:
    window_ns: int
    busy_ns: int
    device_ns_by_name: dict[str, int]
    launches_by_name: dict[str, int]
    idle_ns_by_host: dict[str, int]

    def total_ns(self, word: str) -> int:
        return sum(v for k, v in self.device_ns_by_name.items() if word in k)

    def launches(self, word: str) -> int:
        return sum(v for k, v in self.launches_by_name.items() if word in k)


def events_of(prof) -> list[Event]:
    """Every event of a finished profiler session."""
    from torch.autograd import DeviceType

    out = []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            start = e.start_ns()
            device = e.device_type() == DeviceType.CUDA
            if device and e.is_user_annotation():
                continue  # a host span mirrored onto the device's timeline
            out.append(Event(e.name(), start, start + e.duration_ns(), device))
    except AttributeError:
        for e in prof.events():
            out.append(Event(e.name, int(e.time_range.start * 1000), int(e.time_range.end * 1000),
                             e.device_type == DeviceType.CUDA))
    return out


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(events: list[Event]) -> TraceSummary | None:
    """None when the profiler recorded no device operation in the window."""
    spans = [e for e in events if not e.device and e.name == "portbench.profiled"]
    dev = [e for e in events if e.device and e.end > e.start and not e.name.startswith("portbench.")]
    if not dev:
        return None
    if spans:
        w0, w1 = spans[0].start, spans[0].end
    else:
        w0, w1 = min(e.start for e in events), max(e.end for e in events)
    clipped = [(max(e.start, w0), min(e.end, w1)) for e in dev if e.end > w0 and e.start < w1]
    busy_iv = _union(clipped)
    busy = sum(e - s for s, e in busy_iv)
    by_name: dict[str, int] = {}
    count: dict[str, int] = {}
    for e in dev:
        if e.end <= w0 or e.start >= w1:
            continue
        key = e.name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0) + min(e.end, w1) - max(e.start, w0)
        count[key] = count.get(key, 0) + 1
    host = sorted((e for e in events if not e.device and e.name != "portbench.profiled"),
                  key=lambda e: e.start)
    idle: dict[str, int] = {}
    edges = [w0] + [x for iv in busy_iv for x in iv] + [w1]
    active: list[Event] = []
    i = 0
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) // 2
        while i < len(host) and host[i].start <= mid:
            active.append(host[i])
            i += 1
        active = [a for a in active if a.end >= mid]
        label = _host_label(active)
        idle[label] = idle.get(label, 0) + e - s
    return TraceSummary(w1 - w0, busy, by_name, count, idle)


def _host_label(active: list[Event]) -> str:
    """The harness span and the innermost host operation among ``active``
    (the host events that cover one instant, in order of start)."""
    outer, inner = "outside the harness's spans", None
    for e in active:
        if e.name in HARNESS:
            outer = e.name
        else:
            inner = e
    return outer if inner is None else f"{outer} > {inner.name[:NAME_CHARS]}"


def breakdown(t: TraceSummary) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten host states the device waited longest in, in
    seconds over the profiled part of the window."""
    top = sorted(t.device_ns_by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(t.idle_ns_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v / 1e9] for k, v in top],
            "idle_gaps": [[k, v / 1e9] for k, v in gaps]}
