#!/usr/bin/env python3
"""One split-ELL step and ``run(10)`` of the ``ell`` tier on the
``graph500_22.solve`` cell's layout, written to a file, so that the kernels
of two trees can be held to each other bit for bit.

From the repository root, on a machine with a CUDA card:

    PYTHONPATH=<tree>/src python3 scripts/ell_step_bits.py --out A.pt
    python3 scripts/ell_step_bits.py --compare A.pt B.pt

The graph is the cell's (``perfbench/graphs/kronecker.py`` at the
configuration's scale, ``--seed``), whichever tree's program is on
``PYTHONPATH``.  The step starts from a fixed random rank vector; the file
holds its new vector and leak and the ranks of ``run(10)``.  ``--compare``
prints whether each is bit-equal and exits non-zero if one is not.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def dump(seed: int, out: str) -> None:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from perfbench.graphs import kronecker
    from repro_torch.kernels.ell_step import ell_step
    from repro_torch.obs.registry import NullRegistry
    from repro_torch.pagerank import PageRankEngine
    cfg = json.loads((ROOT / "perfbench/configs/graph500_22.json")
                     .read_text())
    g = kronecker.make(cfg, seed, "cuda")
    eng = PageRankEngine(g.src, g.dst, g.n, d=cfg["d"], backend="ell",
                         device="cuda", metrics=NullRegistry())
    x = torch.from_numpy(np.random.default_rng(seed).random(g.n)).float()
    x = (x / x.sum()).cuda()
    new, leak = ell_step(eng.operands, eng._ell_meta, eng._dang, x,
                         torch.sum(x * eng._dang), d=eng.d)
    torch.save({"new": new.cpu(), "leak": leak.cpu(),
                "run10": eng.run(10).cpu(), "layout": eng.layout,
                "program": str(Path(sys.modules["repro_torch"].__file__)
                               .parents[1])}, out)
    print(f"wrote {out}: n = {g.n}, {eng.layout}")


def compare(a: str, b: str) -> int:
    import torch
    A, B = torch.load(a), torch.load(b)
    bad = 0
    for key in ("new", "leak", "run10"):
        same = torch.equal(A[key], B[key])
        bad += not same
        print(f"{key}: {'bit-equal' if same else 'DIFFERENT'} "
              f"({A['program']} vs {B['program']})")
    print(f"layout: {A['layout']} / {B['layout']}")
    return int(bad > 0 or A["layout"] != B["layout"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    dump(args.seed, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
