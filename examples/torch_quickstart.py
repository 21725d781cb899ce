"""Quickstart on the PyTorch port: the paper's pipeline end to end.

The port's counterpart of `quickstart.py`, with the same five steps and
the same printed numbers:

1. Encode/decode fabric messages (Fig. 1B) — bit-exact vs the paper.
2. Matrix-vector multiply with the Fig. 3 schedule (N+3 steps), the matrix
   loaded by Prog messages hopping through the fabric.
3. PageRank a small protein network three ways and cross-check: the native
   dense loop, the fabric simulator, and the unpadded step kernel
   (`ops.pagerank_iteration`, a CUDA kernel on the card).
4. The Fig. 4C tiled schedule on a network larger than one fabric.
5. The paper's headline number from the analytical model (213.6 ms), a
   time of the paper's 200 MHz fabric, not of the card.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
      (the card by default)
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import isa, schedule, timing
from repro_torch.core.isa import Message
from repro_torch.graph.generators import protein_network
from repro_torch.graph.transition import build_transition_dense
from repro_torch.kernels import ops
from repro_torch.kernels.common import resolve_device
from repro_torch.pagerank import pagerank_dense_fixed, pagerank_on_fabric
from repro_torch.pagerank.sparse import top_k_proteins


def allclose(a, b, **tol) -> None:
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **tol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    dev = resolve_device(ap.parse_args(argv).device)

    print("=" * 64)
    print("1. 64-bit message codec (Fig. 1B) — paper's Fig. 5 values")
    print("=" * 64)
    for hx in ["00f44121999a0051", "00d7404000000091"]:
        m = isa.from_hex(hx, device=dev)
        print(f"  0x{hx} -> {isa.describe(m)}")
    m = Message.make(isa.PROG, 5, 10.1, isa.A_ADD, 15, device=dev)
    assert isa.to_hex(m) == "00f44121999a0051"
    print("  round-trip exact: OK")

    print()
    print("=" * 64)
    print("2. Fig. 3 MV schedule on the fabric simulator")
    print("=" * 64)
    A = torch.arange(12, dtype=torch.float32, device=dev).reshape(4, 3)
    b = torch.tensor([1.0, 2.0, 3.0], device=dev)
    res = schedule.matvec(A, b, use_messages=True)
    print(f"  A@b = {res.result.cpu().numpy()}  (steps = {res.steps} = N+3)")
    assert res.steps == 7

    print()
    print("=" * 64)
    print("3. PageRank on a 60-protein network — three tiers")
    print("   (60x61 = 3660 sites fits the 4096-site fabric whole; larger")
    print("    networks use the Fig. 4C tiled schedule, step 4)")
    print("=" * 64)
    n = 60
    src, dst = protein_network(n, seed=0)
    H = build_transition_dense(src, dst, n, device=dev)

    pr_native = pagerank_dense_fixed(H, n_iters=50)
    pr_fabric, steps, secs = pagerank_on_fabric(H, n_iters=50)
    pr_kernel = torch.full((n,), 1.0 / n, device=dev)
    for _ in range(50):
        pr_kernel = ops.pagerank_iteration(H, pr_kernel)

    allclose(pr_native, pr_fabric, rtol=1e-4)
    allclose(pr_native, pr_kernel, rtol=1e-4)
    idx, _ = top_k_proteins(pr_native, k=5)
    print("  native torch == fabric simulator == step kernel: OK")
    print(f"  fabric steps: {steps} (= 50 x (N+6)); "
          f"@200MHz: {secs * 1e3:.3f} ms")
    print(f"  top-5 proteins: {[int(i) for i in idx]}")

    print()
    print("=" * 64)
    print("4. Fig. 4C tiled schedule on a 150-protein network (> one fabric)")
    print("=" * 64)
    n2 = 150
    src2, dst2 = protein_network(n2, seed=1)
    H2 = build_transition_dense(src2, dst2, n2, device=dev)
    tiled = schedule.pagerank_tiled(H2, n_iters=20)
    ref2 = pagerank_dense_fixed(H2, n_iters=20)
    allclose(tiled.result, ref2, rtol=1e-4, atol=1e-7)
    exp_steps = 20 * timing.pagerank_tiles(n2) * (64 + 6)
    assert tiled.steps == exp_steps
    print(f"  tiled result == dense reference: OK "
          f"({tiled.steps} steps = 20 iters x {timing.pagerank_tiles(n2)}"
          f" tiles x 70)")

    print()
    print("=" * 64)
    print("5. The paper's headline (Fig. 6B)")
    print("=" * 64)
    t = timing.pagerank_latency_s(5000, 100)
    print(f"  5000 proteins, 100 iterations, 4096 sites @ 200 MHz: "
          f"{t * 1e3:.2f} ms  (paper: 213.6 ms)")
    print("\nquickstart: ALL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
