"""Protein-network analysis — the paper's application, on the PyTorch port.

The port's counterpart of ``pagerank_protein_network.py``: builds a
5000-protein scale-free interactome (hu.MAP-like statistics), ranks the
proteins on every tier of :mod:`repro_torch.launch.pagerank_run`, and
prints each tier's wall time on the device beside the paper's model of its
own fabric.

Run:  PYTHONPATH=src python examples/torch_pagerank_protein_network.py
      [--nodes N] [--device cpu] [--backend bsr] [--shards 4]
"""
import sys

from repro_torch.launch.pagerank_run import run

if __name__ == "__main__":
    run(sys.argv[1:])
