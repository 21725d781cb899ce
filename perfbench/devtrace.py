"""Two traced stretches of a run under ``torch.profiler``, reduced to what
the per-layer metrics and the result line's ``breakdown`` read.

The first stretch records the device alone (CUPTI's kernel records cost
the host little), and gives

* ``window_s``: the stretch on the host's clock, from a start at which
  every card of the cell is synchronized to an end at which every card is;
* ``busy_s_per_card``: on each card of the cell, the union of the intervals
  of the device operations that the profiler placed on it (by the event's
  device index; on a cell of one card every operation is its own), and
  ``busy_s``, their mean: one card's busy time (the device-side copies of
  ``record_function`` ranges are labels, not operations, and are left
  out);
* ``kernels``: kernel launches on all the cards (copies and memsets not
  counted);
* ``device_ops``: the ten device operations that took most time, summed
  by name over the cards.

The second records the host's operations as well, which slows the host,
and gives only ``idle_gaps``: the time in which no card of the cell ran
anything, between device operations, summed by what the host was doing
then (the innermost host operation of the harness's thread around the
middle of each gap), the ten largest.
"""
from __future__ import annotations

import time
from collections import Counter

STRETCH = "perfbench.stretch"
NAME_CHARS = 160


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS] + "..."


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host, points):
    """For each point, the name of the innermost host event around it
    (``host``: properly nested ``(start, end, name)``)."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out = {}
    stack: list = []
    j = 0
    for p in sorted(points):
        while j < len(host) and host[j][0] <= p:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out[p] = stack[-1][2] if stack else "host"
    return out


def _device_events(events, annotations=()):
    """``(start, end, name, card)`` of the device operations among
    ``events``; ``card`` is the profiler's device index."""
    from torch.autograd import DeviceType
    names = set(annotations) | {e.name for e in events
                                if getattr(e, "is_user_annotation", False)}
    return [(e.time_range.start, e.time_range.end, e.name, e.device_index)
            for e in events
            if e.device_type == DeviceType.CUDA and e.name not in names
            and not getattr(e, "is_user_annotation", False)]


def busy_per_card(device, cards) -> list[float]:
    """Seconds of the union of device operations on each of ``cards``
    (``device``: ``(start, end, name, card)`` in µs).  With one card every
    operation is its own, whatever index the profiler gave it."""
    groups = ([device] if len(cards) == 1 else
              [[op for op in device if op[3] == c] for c in cards])
    return [sum(t - s for s, t in _union((s, t) for s, t, *_ in g)) / 1e6
            for g in groups]


def device_stretch(torch, body, devices) -> tuple[object, dict]:
    """Run ``body()`` with the device's operations recorded; returns its
    value and the busy time, launches and device operations over the
    cell's ``devices``."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.drivers import sync_all
    sync_all(devices)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value = body()
        sync_all(devices)
        window_s = time.perf_counter() - t0
    return value, {"window_s": window_s,
                   **reduce_device(prof.events(),
                                   [torch.device(d).index for d in devices])}


def reduce_device(events, cards) -> dict:
    """The device-only stretch's profiler ``events`` on the cell's
    ``cards`` (device indices, one per chip) reduced to its busy time (the
    mean card's, and each card's), launches and device operations."""
    device = _device_events(events)
    per_card = busy_per_card(device, cards)
    by_op = Counter()
    for s, t, name, _ in device:
        by_op[_short(name)] += (t - s) / 1e6
    return {
        "busy_s": sum(per_card) / len(per_card),
        "busy_s_per_card": per_card,
        "kernels": sum(1 for _, _, name, _ in device if not _is_copy(name)),
        "device_ops": [[k, v] for k, v in by_op.most_common(10)],
    }


def host_stretch(torch, body, devices) -> tuple[object, dict]:
    """Run ``body()`` with the host's operations recorded as well; returns
    its value, its time on the host's clock and the idle gaps (no card of
    the cell's ``devices`` busy) by what the host was doing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.drivers import sync_all
    sync_all(devices)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            t0 = time.perf_counter()
            value = body()
            sync_all(devices)
            window_s = time.perf_counter() - t0
    events = prof.events()
    stretch = [e for e in events if e.name == STRETCH
               and e.device_type == DeviceType.CPU]
    ws, we = stretch[0].time_range.start, stretch[0].time_range.end
    thread = stretch[0].thread
    device = [(max(s, ws), min(t, we))
              for s, t, *_ in _device_events(events, {STRETCH})
              if t > ws and s < we]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.thread == thread
            and e.name != STRETCH]
    gaps = []
    edge = ws
    for s, t in _union(device) + [[we, we]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    labels = _innermost(host, [(a + b) / 2 for a, b in gaps])
    by_gap = Counter()
    for a, b in gaps:
        by_gap[_short(labels[(a + b) / 2])] += (b - a) / 1e6
    return value, {"window_s": window_s,
                   "idle_gaps": [[k, v] for k, v in by_gap.most_common(10)]}
