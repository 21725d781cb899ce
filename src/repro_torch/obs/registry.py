"""Process-wide metrics: counters, gauges, windowed-quantile histograms,
spans, and a JSONL event log.

This is the PyTorch port's own copy of ``repro.obs.registry`` (the port
imports nothing of the JAX package); its JSONL event schema v1 is
byte-compatible with the JAX package's, so the same offline tooling reads
both packages' logs.

The serving north star ("millions of users") is a latency-distribution
problem, not a mean-latency problem — MELOPPR (PAPERS.md) frames PPR
serving in p50/p95 terms — and the engine's convergence behavior is a
trajectory, not a scalar.  This module is the host-side half of the
observability layer (the on-device half is :mod:`repro_torch.obs.trace`):

* :class:`Counter` / :class:`Gauge` — plain monotonic counts and
  last-value gauges.
* :class:`Histogram` — streaming windowed quantiles: a bounded ring of the
  last ``window`` observations with nearest-rank quantiles over the sorted
  window.  Deterministic (no sampling, no randomized sketches), so a
  quantile computed here is *bit-identical* to one recomputed from the
  same observations — what lets ``scripts/obs_report.py`` reproduce the
  registry's p50/p95 exactly from the JSONL event log.
* :class:`MetricsRegistry` — the named instrument store, a
  :meth:`~MetricsRegistry.span` context manager (wall-time via
  ``perf_counter`` into a ``span.<name>`` histogram + a ``span`` event,
  optionally forwarding to ``torch.profiler.record_function`` so spans
  land in device profiles too), and an append-only event log with monotonic
  timestamps — written live to a JSONL file when ``jsonl_path`` is given.
* :class:`NullRegistry` — the same surface as no-ops: the uninstrumented
  baseline ``benchmarks/observability_bench.py`` measures against, and the
  zero-overhead opt-out for latency-critical deployments.

Every instrument is exported by :meth:`MetricsRegistry.as_dict` as a
stable, ``json.dumps``-safe dict (sorted names, plain scalars), so
downstream tooling can diff two dumps or pin one in a golden test.
"""
from __future__ import annotations

import json
import math
import time
from collections import deque
from contextlib import contextmanager

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "NullRegistry", "default_registry", "set_default_registry",
           "DEFAULT_WINDOW", "EVENT_SCHEMA_VERSION"]

DEFAULT_WINDOW = 2048          # histogram ring size (last-K observations)
MAX_EVENTS = 100_000           # in-memory event bound (JSONL file unbounded)
EVENT_SCHEMA_VERSION = 1       # bump when an event's key set changes


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, k: int = 1) -> int:
        self.value += k
        return self.value


class Gauge:
    """Last-set value (e.g. seconds of freshness lag)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: float | None = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded-memory latency distribution: count/sum/min/max over the full
    stream, nearest-rank quantiles over the last ``window`` observations.

    Quantile rule: ``q`` maps to the ``ceil(q * k)``-th smallest of the
    ``k`` retained values (1-based) — the classic nearest-rank definition,
    deterministic and exactly reproducible from the same value sequence.
    """

    __slots__ = ("window", "_ring", "count", "total", "min", "max")

    def __init__(self, window: int = DEFAULT_WINDOW):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._ring: deque[float] = deque(maxlen=self.window)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self._ring.append(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> float | None:
        if not self._ring:
            return None
        vals = sorted(self._ring)
        rank = max(1, math.ceil(q * len(vals)))
        return vals[min(rank, len(vals)) - 1]

    def summary(self) -> dict:
        """Stable JSON-safe snapshot (``window`` included so a recompute
        from the event log can match the retention exactly)."""
        if self.count == 0:
            return {"count": 0, "window": self.window}
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99), "window": self.window}


class MetricsRegistry:
    """Named instruments + the JSONL event log, one per serving stack.

    ``jsonl_path`` turns on live appends: every :meth:`event` writes (and
    flushes) one JSON line, so the log survives a crash mid-run.  Events
    carry ``t_ms`` — milliseconds of ``time.monotonic()`` since the
    registry was built (immune to wall-clock adjustment, non-decreasing) —
    a schema version ``v``, the ``kind``, then the caller's fields in
    sorted key order.  In-memory retention is bounded at ``MAX_EVENTS``
    (``events_dropped`` counts evictions); the file is never truncated.

    ``profiler_annotations=True`` additionally wraps every :meth:`span` in
    ``torch.profiler.record_function`` so host spans show up in device
    traces; off by default (it is free only when no profiler is attached,
    and the observability bench measures the default configuration).
    """

    def __init__(self, jsonl_path: str | None = None,
                 window: int = DEFAULT_WINDOW,
                 profiler_annotations: bool = False,
                 max_events: int = MAX_EVENTS):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self._events: deque[dict] = deque(maxlen=int(max_events))
        self.events_dropped = 0
        self.window = int(window)
        self.profiler_annotations = bool(profiler_annotations)
        self._t0 = time.monotonic()
        self.jsonl_path = jsonl_path
        self._fh = None

    # ---------------------------- instruments --------------------------- #
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, window: int | None = None) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(
                self.window if window is None else window)
        return h

    # ------------------------------ events ------------------------------ #
    @property
    def events(self) -> list[dict]:
        """The retained event log, oldest first (a copy)."""
        return list(self._events)

    def event(self, kind: str, **fields) -> dict:
        """Append one structured event; fields must be JSON-serializable."""
        ev = {"v": EVENT_SCHEMA_VERSION,
              "t_ms": round((time.monotonic() - self._t0) * 1e3, 3),
              "kind": kind}
        for k in sorted(fields):
            ev[k] = fields[k]
        if len(self._events) == self._events.maxlen:
            self.events_dropped += 1
        self._events.append(ev)
        if self.jsonl_path is not None:
            if self._fh is None:
                self._fh = open(self.jsonl_path, "a")
            self._fh.write(json.dumps(ev) + "\n")
            self._fh.flush()
        return ev

    @contextmanager
    def span(self, name: str, **fields):
        """Time a block into the ``span.<name>`` histogram + a ``span``
        event (recorded even if the block raises, so failed refreshes and
        aborted solves still leave a latency sample)."""
        ann = None
        if self.profiler_annotations:
            from torch.profiler import record_function
            ann = record_function(name)
            ann.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            ms = (time.perf_counter() - t0) * 1e3
            self.histogram(f"span.{name}").observe(ms)
            self.event("span", name=name, ms=ms, **fields)

    # ------------------------------ export ------------------------------ #
    def as_dict(self) -> dict:
        """Stable JSON-safe export of every instrument (sorted names)."""
        return {
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k].value
                       for k in sorted(self._gauges)},
            "histograms": {k: self._hists[k].summary()
                           for k in sorted(self._hists)},
            "n_events": len(self._events),
            "events_dropped": self.events_dropped,
        }

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)

    def dump_jsonl(self, path: str) -> None:
        """Write the retained events as JSONL (use ``jsonl_path`` at
        construction for live, eviction-proof appends instead)."""
        with open(path, "w") as f:
            for ev in self._events:
                f.write(json.dumps(ev) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class _NullCounter(Counter):
    def inc(self, k: int = 1) -> int:
        return 0


class _NullGauge(Gauge):
    def set(self, v: float) -> None:
        pass


class _NullHistogram(Histogram):
    def observe(self, v: float) -> None:
        pass


class NullRegistry(MetricsRegistry):
    """The no-op registry: same surface, nothing recorded.  The
    uninstrumented baseline for overhead measurement, and the opt-out for
    callers that want literally zero host-side bookkeeping."""

    def __init__(self):
        super().__init__()
        self._null_counter = _NullCounter()
        self._null_gauge = _NullGauge()
        self._null_hist = _NullHistogram()

    def counter(self, name: str) -> Counter:
        return self._null_counter

    def gauge(self, name: str) -> Gauge:
        return self._null_gauge

    def histogram(self, name: str, window: int | None = None) -> Histogram:
        return self._null_hist

    def event(self, kind: str, **fields) -> dict:
        return {}

    @contextmanager
    def span(self, name: str, **fields):
        yield


_default: MetricsRegistry | None = None


def default_registry() -> MetricsRegistry:
    """The process-default registry (created on first use).  Engines built
    without an explicit ``metrics=`` record here, so one process's solves,
    updates, and serves land in one log."""
    global _default
    if _default is None:
        _default = MetricsRegistry()
    return _default


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-default registry (e.g. for a JSONL-backed one at
    program start); returns the previous registry."""
    global _default
    prev, _default = _default, reg
    return prev if prev is not None else reg
