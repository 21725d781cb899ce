"""The port's live-serving example on the CPU against the JAX package's:
``examples/torch_streaming_pagerank.py`` and
``examples/streaming_pagerank.py`` on the same stream, on the ``ell``
tier and on both sharded tiers (the JAX example on 8 virtual devices, the
port's on a mesh of 8 CPU positions)."""
import re
import subprocess
import sys

import pytest

from test_torch_scripts import ROOT, example


@pytest.mark.parametrize("backend", ["ell", "dense_sharded", "ell_sharded"])
def test_streaming_example_matches_jax(backend, tmp_path):
    """Four ticks at N = 300: the same refresh strategy and top proteins
    per tick as the JAX example, its final L1 against a fresh solve under
    the example's own 1e-4 gate, and its events read by
    scripts/obs_report.py."""
    args = ["--nodes", "300", "--steps", "4", "--backend", backend]
    jax_out = example(["examples/streaming_pagerank.py", *args])
    ev, met = tmp_path / "ev.jsonl", tmp_path / "m.json"
    out = example(["examples/torch_streaming_pagerank.py", *args,
                    "--device", "cpu", "--shards", "8", "--jsonl", str(ev),
                    "--metrics-out", str(met)])

    def ticks(text):
        return re.findall(r"refresh=(\w+).*uid\d+: (\[.*\])", text)

    assert len(ticks(out)) == 4 and ticks(out) == ticks(jax_out)
    l1 = [float(re.search(r"from-scratch\) = (\S+)", t).group(1))
          for t in (out, jax_out)]
    assert max(l1) <= 1e-4
    if backend.endswith("sharded"):
        assert "mesh {" in out and "'cpu'" in out
    report = subprocess.run(
        [sys.executable, "scripts/obs_report.py", str(ev), "--metrics",
         str(met)], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert report.returncode == 0, report.stdout[-2000:]
