#!/usr/bin/env python3
"""Candidate tiles of the BSR SpMV kernel (K3) on one CUDA card.

Run from the repository root:

    python3 scripts/k3_tile_sweep.py [--out FILE]

``src/repro_torch/kernels/csrc/bsr_spmv.cu`` picks one tile per batch size
(its note has the table).  This script instantiates the candidate tiles
below from that same source (a translation unit that includes it, built
with ``nvcc`` into ``build/k3_tile_sweep/``, one library per storage type,
in parallel), and for each candidate and storage type:

* checks it on the 5000-protein network's 40 x 40-block layout at its
  batch size and on small layouts (bs 4, 32, 36 and 256, an empty block
  row, B past the tile) against the plain version (rtol 1e-5, atol 1e-9)
  and against the bits of the wrapper's own launch: every tile sums in the
  same order, so all give the same bits;
* times it on that layout with the L2 flushed before the call and back to
  back, as ``chip_smoke.py`` times the kernels, beside cuSPARSE's BSR
  product (``torch.sparse_bsr_tensor @ X``, f32) at the same B.

It prints one line per candidate and writes them as JSON lines to
``--out`` (default ``build/k3_tile_sweep/tiles.jsonl``).  It needs a card
and the CUDA toolkit; without a card it exits non-zero, and it exits 1 if
a candidate fails a check.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (TIGHT, bsr_case, cuda_ms, cuda_ms_cold,  # noqa: E402
                        nvidia_smi)

PRECISIONS = ("f32", "bf16", "f16", "int8")
# (B, RL, QW, WR, WQ, ST): the tile each batch size takes in
# csrc/bsr_spmv.cu comes first in its group, then the alternatives
CANDIDATES = [
    (1, 1, 1, 2, 1, 4), (1, 1, 1, 4, 1, 4), (1, 2, 1, 2, 1, 4),
    (1, 1, 1, 2, 1, 8),
    (8, 2, 4, 2, 2, 4), (8, 2, 4, 2, 2, 3), (8, 1, 4, 2, 2, 4),
    (8, 2, 8, 2, 1, 4),
    (16, 4, 4, 1, 4, 4), (16, 4, 4, 1, 4, 3), (16, 2, 8, 2, 2, 3),
    (32, 4, 8, 1, 4, 3), (32, 4, 8, 1, 4, 2), (32, 8, 8, 1, 4, 2),
    (64, 8, 8, 1, 4, 2), (64, 8, 8, 1, 4, 3), (64, 4, 8, 1, 4, 3),
    (64, 4, 16, 1, 4, 2), (64, 4, 16, 2, 2, 2), (64, 8, 4, 1, 4, 3),
]
TYPES = {"f32": "float", "bf16": "__nv_bfloat16", "f16": "__half",
         "int8": "int8_t"}


def translation_unit(ctype: str) -> str:
    cases = "\n".join(
        f"    case {i}: return static_cast<int>(launch_tile<{ctype}, "
        f"Tile<{rl}, {qw}, {wr}, {wq}, {st}>>(blocks, "
        f"static_cast<const int*>(cols), "
        f"static_cast<const float*>(X), static_cast<float*>(Y), nb_r, mb, "
        f"bs, Mp, B, static_cast<cudaStream_t>(stream)));"
        for i, (_, rl, qw, wr, wq, st) in enumerate(CANDIDATES))
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "bsr_spmv.cu"
    return (f'#include "{src}"\n\nextern "C" int sweep_launch(int i, '
            "const void* blocks, const void* cols, const void* X, void* Y, "
            "int nb_r, int mb, int bs, int Mp, int B, void* stream) {\n"
            f"  switch (i) {{\n{cases}\n    default: return -1;\n  }}\n}}\n")


def build() -> dict:
    """One library per storage type, all built at once."""
    from repro_torch.kernels import _build
    out = _build.BUILD_ROOT.parent / "k3_tile_sweep"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for p, ctype in TYPES.items():
        cu = out / f"tiles_{p}.cu"
        cu.write_text(translation_unit(ctype))
        jobs[p] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"libtiles_{p}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for p, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {p}:\n{log}")
        lib = ctypes.CDLL(str(out / f"libtiles_{p}.so"))
        lib.sweep_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        libs[p] = lib
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=str(ROOT / "build" / "k3_tile_sweep"
                                             / "tiles.jsonl"))
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k3_tile_sweep: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.graph.generators import protein_network
    from repro_torch.graph.sparse import BSRMatrix
    from repro_torch.kernels import bsr_spmv as k3
    from repro_torch.kernels.ref import bsr_spmv_ref
    from repro_torch.obs.registry import NullRegistry
    from repro_torch.pagerank import PageRankEngine

    card = nvidia_smi()
    print(f"card: {card}")
    libs = build()
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    src, dst = protein_network(5000, seed=0)
    rng = np.random.default_rng(7)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    failed = 0
    with open(args.out, "w") as out:
        for p in PRECISIONS:
            eng = PageRankEngine(src, dst, 5000, d=0.85, backend="bsr",
                                 precision=p, device=dev,
                                 metrics=NullRegistry())
            bsr = eng.operands[0]
            blocks, cols = bsr.blocks, bsr.block_cols
            nb_r, mb, bs, _ = blocks.shape
            Mp = -(-5000 // bs) * bs
            Xs = {}
            for B in sorted({c[0] for c in CANDIDATES}):
                Xh = np.zeros((B, Mp), np.float32)
                Xh[:, :5000] = rng.dirichlet(np.ones(5000), size=B)
                Xs[B] = torch.from_numpy(Xh).to(dev)
            library = {}
            if p == "f32":
                real = (blocks != 0).flatten(2).any(dim=2)
                crow = torch.zeros(nb_r + 1, dtype=torch.int64, device=dev)
                crow[1:] = torch.cumsum(real.sum(dim=1), 0)
                sparse = torch.sparse_bsr_tensor(
                    crow, cols[real].long(), blocks[real],
                    size=(nb_r * bs, Mp))
                for B, X in Xs.items():
                    XT = X.T.contiguous()
                    library[B] = cuda_ms_cold(torch, lambda: sparse @ XT,
                                              flush) * 1e3

            def launch(i, bl, cl, X):
                Y = torch.empty((X.shape[0], bl.shape[0] * bl.shape[2]),
                                device=dev)
                err = libs[p].sweep_launch(
                    i, bl.data_ptr(), cl.data_ptr(), X.data_ptr(),
                    Y.data_ptr(), bl.shape[0], bl.shape[1], bl.shape[2],
                    X.shape[1], X.shape[0],
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"tile {i}: cudaError_t {err}")
                return Y

            for i, cand in enumerate(CANDIDATES):
                B = cand[0]
                X = Xs[B]
                Y = launch(i, blocks, cols, X)
                torch.cuda.synchronize()
                checks = {
                    "plain": bool(torch.allclose(
                        Y, bsr_spmv_ref(blocks, cols, X), **TIGHT)),
                    "wrapper_bits": bool(torch.equal(
                        Y, k3.bsr_spmv(blocks, cols, X))),
                    "repeat_bits": bool(torch.equal(
                        Y, launch(i, blocks, cols, X)))}
                small = True
                for n, sbs, dens, SB in ((200, 32, 0.3, B),
                                         (300, 36, 0.3, B + 1),
                                         (600, 256, 0.3, B),
                                         (300, 128, 0.5, 2 * B + 3),
                                         (130, 4, 0.5, B)):
                    bl, cl, X2 = bsr_case(np, torch, BSRMatrix, n, sbs, dens,
                                          SB, p, seed=n + sbs + SB,
                                          empty_row=True)
                    if p != "int8":
                        bl = bl.to(blocks.dtype)
                    bl, cl = bl.to(dev), cl.to(dev)
                    X2 = torch.nn.functional.pad(
                        torch.from_numpy(X2).to(dev), (0, (-n) % sbs))
                    Y2 = launch(i, bl, cl, X2)
                    small = small and bool(
                        torch.allclose(Y2, bsr_spmv_ref(bl, cl, X2), **TIGHT)
                        and torch.equal(Y2, k3.bsr_spmv(bl, cl, X2)))
                checks["small_layouts"] = small
                ok = all(checks.values())
                failed += not ok
                row = {"storage": p, "B": B,
                       "tile": dict(zip(("RL", "QW", "WR", "WQ", "ST"),
                                        cand[1:])),
                       "production": CANDIDATES.index(
                           next(c for c in CANDIDATES if c[0] == B)) == i,
                       "flushed_us": cuda_ms_cold(
                           torch, lambda: launch(i, blocks, cols, X),
                           flush) * 1e3,
                       "warm_us": cuda_ms(
                           torch, lambda: launch(i, blocks, cols, X)) * 1e3,
                       "cusparse_us": library.get(B), "checks": checks,
                       "card": card}
                out.write(json.dumps(row) + "\n")
                lib_us = row["cusparse_us"]
                print(f"  {p} B={B} tile {row['tile']}"
                      + (" (the kernel's)" if row["production"] else "")
                      + f": {row['flushed_us']:.2f} us flushed, "
                      f"{row['warm_us']:.2f} us warm"
                      + ("" if lib_us is None else
                         f"; cuSPARSE {lib_us:.2f} us flushed")
                      + ("" if ok else f"; FAILED {checks}"), flush=True)
    print(f"{len(CANDIDATES) * len(PRECISIONS)} candidates, {failed} "
          f"failed; {card}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
