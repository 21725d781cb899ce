"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (:mod:`perfbench.
run`).  Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by its name (:mod:`perfbench.bench`):

* ``configs/<config>.json``: the deployment, its source and cuts;
* ``traffic/<mix>.json``: the mix's parameters, read by the general
  generator (:mod:`perfbench.loadgen`), and the names of its parts:
  ``driver`` (``drivers/<name>.py``: how the program is driven, set up,
  judged and replaced by the control), and for an open loop ``arrivals``
  (``arrivals/<name>.py``: when requests are due) and ``seed_sets``
  (``seedsets/<name>.py``: what each query asks);
* ``limits/<cell>.json``: the limits of the comparison that decides
  ``correct`` (:mod:`perfbench.checks`);
* ``metrics/<metric>.py``: the metric's reader;
* ``graphs/<generator>.py``: a configuration's graph;
* ``parked.json``: entries of cells proven on the card but held back from
  ``BENCHMARK.json``, in its format, for a later benchmark to move in.

The yardstick lives here too: the frozen graph generators (``graphs/``),
the plain float64 reference (``reference/``), the work bytes of an
iteration (:mod:`perfbench.work`), the card's peaks
(:mod:`perfbench.peaks`) and the reduction of a profiler trace
(:mod:`perfbench.devtrace`).  None of it imports JAX or the JAX package;
``reference/`` imports nothing of the program either.
"""
import importlib


def find(kind: str, name: str):
    """The module of the part ``name`` of one kind:
    ``perfbench/<kind>/<name>.py``."""
    return importlib.import_module(f"perfbench.{kind}.{name}")
