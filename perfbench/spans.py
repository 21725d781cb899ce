"""The program's own spans and profiler ranges, for the metrics of phases
inside the program.

* :func:`records` gives the span records of the registry the run handed
  the program (``repro_torch.obs.registry.MetricsRegistry`` in a traced
  run): each span's ``name``, ``id``, the ``parent`` span's id,
  ``start_ns`` / ``end_ns`` on ``time.monotonic_ns`` and ``fields``.  A
  reader is handed ``rec`` alone, and ``rec`` carries no copy of them, so
  they are read off that registry, found among the live objects.  A
  registry that keeps no records (a program from before they existed)
  gives none.
* :func:`prepare_phases` and :func:`phase_s` give the seconds of the last
  ``prepare`` span and of the spans directly inside it: the phases of the
  engine's constructor.
* :func:`by_span` splits a traced stretch's device time by the innermost
  program range (``record_function``) around each device operation.
"""
from __future__ import annotations

import gc
from collections import Counter

from perfbench.devtrace import _innermost

NONE = "(none)"


def records() -> list[dict]:
    """The program's span records of this run, oldest end first: those of
    the live registry whose last span ended last (ids are a registry's
    own, so records of two registries are never mixed)."""
    from repro_torch.obs.registry import MetricsRegistry
    found = [getattr(obj, "span_records", []) for obj in gc.get_objects()
             if issubclass(type(obj), MetricsRegistry)]
    found = [r for r in found if r]
    return max(found, key=lambda r: r[-1]["end_ns"]) if found else []


def prepare_phases(spans: list[dict]) -> dict[str, float]:
    """Seconds of the last ``prepare`` span and of the spans directly
    inside it, by name (spans of one name summed)."""
    top = [r for r in spans if r["name"] == "prepare"]
    if not top:
        return {}
    last = top[-1]
    out = {"prepare": (last["end_ns"] - last["start_ns"]) / 1e9}
    for r in spans:
        if r["parent"] == last["id"]:
            out[r["name"]] = (out.get(r["name"], 0.0)
                              + (r["end_ns"] - r["start_ns"]) / 1e9)
    return out


def phase_s(name: str) -> float | None:
    """Seconds of the spans ``name`` directly inside the last
    ``prepare`` span, or ``None`` where the run recorded none."""
    return prepare_phases(records()).get(name)


def by_span(ops, ranges) -> dict[str, float]:
    """Seconds of device time by the innermost range around each
    operation, :data:`NONE` for those under no range.

    ``ops``: ``(start, end, t)`` of the device operations in µs, where
    ``t`` is the point looked up among ``ranges``: the operation's middle
    on the device's timeline (with the device-side copies of the ranges),
    or its launch on the host's.  ``ranges``: properly nested ``(start,
    end, name)`` in µs.  Overlapping operations count once, so the values
    add up to the union of the operations, the stretch's ``busy_s``."""
    ops = sorted(ops)
    label = _innermost([(s, e, name) for s, e, name in ranges],
                       [t for *_, t in ops])
    out: Counter = Counter()
    edge = float("-inf")
    for s, e, t in ops:
        s = max(s, edge)
        if e > s:
            name = label[t]
            out[NONE if name == "host" else name] += (e - s) / 1e6
        edge = max(edge, e)
    return dict(out)
