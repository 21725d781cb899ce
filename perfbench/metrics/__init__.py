"""One reader per metric: ``read(rec) -> float | None``.

``rec`` is what a run recorded: ``setup_s``; the window's ``window_s``,
``attempted``, ``completed``, ``failed``, per-request ``latencies_s`` and
``lags_s``; the harness's ``spans`` (``prepare``, ``flush``,
``refresh``, in seconds); the program's registry ``counters`` over the
window; ``sweeps`` (``UpdateInfo.iters`` of each refresh); ``graph``
(``n_connected``, ``n_undirected``);
``work_bytes_per_iter``; ``device_kind``; ``chips``, the cell's cards;
and, in a traced run, ``profile`` (:func:`perfbench.devtrace.
device_stretch`'s reduction of the device-only stretch, its ``busy_s``
the mean card's, with the driver's ``iterations`` issued in it).
"""
import numpy as np


def p95(values) -> float | None:
    return float(np.percentile(values, 95)) if len(values) else None


def p50(values) -> float | None:
    return float(np.median(values)) if len(values) else None
