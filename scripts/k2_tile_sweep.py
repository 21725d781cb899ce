#!/usr/bin/env python3
"""Candidate configurations of the streaming matvec kernel (K2) on one
CUDA card.

Run from the repository root:

    python3 scripts/k2_tile_sweep.py [--probe] [--parent DIR] [--out FILE]

``src/repro_torch/kernels/csrc/streaming_matvec.cu`` runs one tile per
storage type and batch size (``Chosen`` there): MT m-tiles of 16 rows per
warp, WR x WQ warps (rows x queries), ST ring stages of KG 32-column
groups, PF (each copy of W fetches 256 bytes into L2).  Every tile sums in
the kernel's one order (``kSplits`` column ranges, the mma accumulator
restarted every ``kRestart`` k-steps).  This script instantiates the
candidates below from that same source (translation units that include
it, built with ``nvcc`` into ``build/k2_tile_sweep/``, all in parallel)
and runs them on the 5120 x 5120 layout of the main path, X rows being
distributions:

* ``--probe``: the accuracy of the split-TF32 product under each
  summation order of ``PROBE_ORDERS`` (the source built with other
  ``K2_SPLITS`` / ``K2_RESTART``: a restart every 1, 2 and 4 k-steps, and
  never: chained through all 640 k-steps of a row with 1 split, or
  through a CTA's 80 with 8) at float32 and bf16 W, B = 1 and 64: the
  largest relative error against the plain version (``X @ W.T`` in
  float32, TF32 off) and whether it meets rtol 1e-5 / atol 1e-9.  Nothing
  is timed.
* otherwise, each candidate and storage type at the batch sizes of its
  queries per CTA (8: B = 1 and 8; 64: B = 64): the same check,
  bit-identical repeats, the bits of the wrapper's own launch, a ragged
  layout (N = 300, M = 132, B + 3 queries); and the time with the
  L2 flushed before the call and back to back, as ``chip_smoke.py`` times
  the kernels, beside ``X @ W.T`` (f32).
* ``--parent DIR``: also builds ``DIR``'s ``streaming_matvec.cu`` (an
  unpacked earlier commit) and times it the same way, in the same run,
  reports whether its bits equal the wrapper's at each storage type and
  batch size (on that layout and the ragged one), and times both it and
  the wrapper's launch at a tiny shape (256 x 256, B = 1), where a launch
  costs little beyond itself.

It prints one line per candidate and writes them as JSON lines to
``--out`` (default ``build/k2_tile_sweep/tiles.jsonl``).  It needs a card
and the CUDA toolkit; without a card it exits non-zero, and it exits 1 if
a candidate fails a check (the probe reports, and exits 0).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (TIGHT, cuda_ms, cuda_ms_cold, k2_case,  # noqa: E402
                        nvidia_smi)

PRECISIONS = ("f32", "bf16", "f16", "int8")
TYPES = {"f32": "float", "bf16": "__nv_bfloat16", "f16": "__half",
         "int8": "int8_t"}
SOURCE = Path("src") / "repro_torch" / "kernels" / "csrc" / \
    "streaming_matvec.cu"
# (QP, MT, WR, WQ, ST, KG, PF): the queries per CTA the candidate is built
# for (8: timed at B = 1 and 8; 64: at B = 64), then its tile; KG 0 stands
# for the groups that fill a 128-byte stage row (1, 2 or 4 by storage type)
CANDIDATES = [
    (8, 2, 4, 1, 3, 0, 1), (8, 2, 4, 1, 3, 0, 0), (8, 2, 4, 1, 2, 0, 0),
    (8, 2, 4, 1, 2, 0, 1), (8, 2, 4, 1, 4, 0, 0), (8, 1, 4, 1, 3, 0, 1),
    (64, 2, 2, 2, 3, 1, 0), (64, 2, 2, 2, 3, 1, 1), (64, 2, 2, 2, 4, 1, 0),
    (64, 2, 4, 2, 3, 1, 0), (64, 2, 4, 1, 3, 1, 0),
]
KEYS = ("QP", "MT", "WR", "WQ", "ST", "KG", "PF")
# the probe: one tile, summed in each order (K2_SPLITS, K2_RESTART)
PROBE_TILE = (64, 2, 4, 1, 3, 1, 0)
PROBE_ORDERS = [(1, 1), (1, 4), (1, 0), (8, 1), (8, 2), (8, 4), (8, 0)]
PROBE_PRECISIONS = ("f32", "bf16")
TYPE_BYTES = {"float": 4, "__nv_bfloat16": 2, "__half": 2, "int8_t": 1}
BATCHES = (1, 8, 64)
N = M = 5120


def resolved(cand, ctype: str) -> tuple:
    """The candidate with KG 0 resolved for storage type ``ctype``."""
    kg = cand[5] or 4 // TYPE_BYTES[ctype]
    return cand[:5] + (kg,) + cand[6:]


def translation_unit(cases, defines=()) -> str:
    """The kernel source with ``defines`` set before it and a
    ``sweep_launch(i, ...)`` that runs case i, ``cases`` being (storage
    type, candidate) pairs."""
    launches = "\n".join(
        f"    case {i}: return static_cast<int>(launch<{ctype}, {c[0]}, "
        f"Cfg<{', '.join(map(str, resolved(c, ctype)[1:]))}>>(W, "
        "static_cast<const float*>(X), static_cast<float*>(Y), N, M, B, "
        "static_cast<cudaStream_t>(stream)));"
        for i, (ctype, c) in enumerate(cases))
    return ("".join(f"#define {k} {v}\n" for k, v in defines)
            + f'#include "{ROOT / SOURCE}"\n\nextern "C" int sweep_launch('
            "int i, const void* W, const void* X, void* Y, int N, int M, "
            "int B, void* stream) {\n"
            f"  switch (i) {{\n{launches}\n    default: return -1;\n  }}\n}}\n")


def build(probe: bool, parent: Path | None) -> tuple[dict, object]:
    """The candidates' libraries (one per storage type, or with --probe one
    per summation order) and the parent's, all built at once."""
    from repro_torch.kernels import _build
    out = _build.BUILD_ROOT.parent / "k2_tile_sweep"
    out.mkdir(parents=True, exist_ok=True)
    if probe:
        tus = {f"order_{s}_{r}": translation_unit(
                   [(TYPES[p], PROBE_TILE) for p in PROBE_PRECISIONS],
                   (("K2_SPLITS", s), ("K2_RESTART", r)))
               for s, r in PROBE_ORDERS}
    else:
        tus = {p: translation_unit([(ctype, c) for c in CANDIDATES])
               for p, ctype in TYPES.items()}
    units = {}
    for name, text in tus.items():
        (out / f"tiles_{name}.cu").write_text(text)
        units[name] = (out / f"tiles_{name}.cu", out / f"libtiles_{name}.so")
    if parent is not None:
        units["parent"] = (parent / SOURCE, out / "libparent.so")
    t0 = time.perf_counter()
    logs = _build.compile_units(units)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and m.groups() != ("0", "0"):
                print(f"  {name}: {line.strip()}")
    args = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    libs = {}
    for name in tus:
        libs[name] = ctypes.CDLL(str(units[name][1]))
        libs[name].sweep_launch.argtypes = args
    parent_lib = None
    if parent is not None:
        parent_lib = ctypes.CDLL(str(units["parent"][1]))
        parent_lib.streaming_matvec_launch.argtypes = args
    return libs, parent_lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--probe", action="store_true",
                        help="accuracy of the restart schedules only")
    parser.add_argument("--parent", type=Path, default=None,
                        help="an unpacked earlier commit to time beside")
    parser.add_argument("--out", default=str(ROOT / "build" / "k2_tile_sweep"
                                             / "tiles.jsonl"))
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k2_tile_sweep: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import streaming_matvec as k2
    from repro_torch.kernels.ref import streaming_matvec_ref

    def kernel_config(p, B):
        """The configuration the wrapper's launch takes: QP, its tile."""
        lib = k2._library()
        lib.streaming_matvec_config.argtypes = (ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p)
        out = (ctypes.c_int * 11)()
        lib.streaming_matvec_config(PRECISIONS.index(p), B, out)
        return tuple(out[:len(KEYS)])

    card = nvidia_smi()
    print(f"card: {card}")
    libs, parent_lib = build(args.probe, args.parent)
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    store = {"f32": torch.float32, "bf16": torch.bfloat16,
             "f16": torch.float16, "int8": torch.int8}

    def operands(n, m, b, p, seed):
        W, X = k2_case(np, n, m, b, p, seed=seed)
        Wt = torch.from_numpy(W).to(dev)
        if p != "int8":
            Wt = Wt.to(store[p])
        return Wt, torch.from_numpy(X).to(dev)

    def launch(lib, i, W, X):
        Y = torch.empty((X.shape[0], W.shape[0]), device=dev)
        args_ = (W.data_ptr(), X.data_ptr(), Y.data_ptr(), W.shape[0],
                 W.shape[1], X.shape[0],
                 torch.cuda.current_stream().cuda_stream)
        err = (lib.sweep_launch(i, *args_) if i is not None
               else lib.streaming_matvec_launch(
                   {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                    torch.int8: 3}[W.dtype], *args_))
        if err:
            raise RuntimeError(f"candidate {i}: cudaError_t {err}")
        return Y

    def rel_err(Y, ref):
        return float(((Y - ref).abs() / ref.abs()).max())

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    failed = n_runs = 0
    with open(args.out, "w") as out:
        if parent_lib is not None:
            # a launch at a tiny shape: what a launch costs beyond its work
            for p in PRECISIONS:
                W, X = operands(256, 256, 1, p, seed=1)
                for name, fn in (
                        ("kernel", lambda: k2.streaming_matvec(W, X)),
                        ("parent", lambda: launch(parent_lib, None, W, X))):
                    row = {"storage": p, "B": 1, "shape": [256, 256],
                           "which": name,
                           "flushed_us": cuda_ms_cold(torch, fn, flush) * 1e3,
                           "warm_us": cuda_ms(torch, fn) * 1e3, "card": card}
                    out.write(json.dumps(row) + "\n")
                    print(f"  {p} 256 x 256 B=1 {name}: "
                          f"{row['flushed_us']:.2f} us flushed, "
                          f"{row['warm_us']:.2f} us warm", flush=True)
        for p in (PROBE_PRECISIONS if args.probe else PRECISIONS):
            for B in ((1, 64) if args.probe else BATCHES):
                chosen = kernel_config(p, B)
                # (library, case, configuration) of each run
                if args.probe:
                    runs = [(f"order_{s_}_{r}",
                             PROBE_PRECISIONS.index(p),
                             dict(zip(KEYS, resolved(PROBE_TILE, TYPES[p])),
                                  SPLITS=s_, RESTART=r))
                            for s_, r in PROBE_ORDERS]
                else:
                    runs = [(p, i, dict(zip(KEYS, resolved(c, TYPES[p]))))
                            for i, c in enumerate(CANDIDATES)
                            if c[0] == chosen[0]]
                W, X = operands(N, M, B, p, seed=N + M + B)
                ref = streaming_matvec_ref(W, X)
                timed = {}
                if not args.probe:
                    if p == "f32":
                        timed["XWT_us"] = cuda_ms_cold(
                            torch, lambda: X @ W.T, flush) * 1e3
                    if parent_lib is not None:
                        Yp = launch(parent_lib, None, W, X)
                        timed["parent_us"] = cuda_ms_cold(
                            torch, lambda: launch(parent_lib, None, W, X),
                            flush) * 1e3
                        timed["parent_warm_us"] = cuda_ms(
                            torch,
                            lambda: launch(parent_lib, None, W, X)) * 1e3
                        timed["parent_rel_err"] = rel_err(Yp, ref)
                    wrapper = k2.streaming_matvec(W, X)
                    if parent_lib is not None:
                        Ws, Xs = operands(300, 132, B + 3, p, seed=B)
                        same = {"5120x5120": torch.equal(Yp, wrapper),
                                "300x132": torch.equal(
                                    launch(parent_lib, None, Ws, Xs),
                                    k2.streaming_matvec(Ws, Xs))}
                        out.write(json.dumps({"storage": p, "B": B,
                                              "parent_bits_equal": same,
                                              "card": card}) + "\n")
                        print(f"  {p} B={B}: the parent's bits equal the "
                              f"wrapper's: {same}", flush=True)
                for name, i, config in runs:
                    lib = libs[name]
                    Y = launch(lib, i, W, X)
                    torch.cuda.synchronize()
                    checks = {
                        "plain": bool(torch.allclose(Y, ref, **TIGHT)),
                        "repeat_bits": bool(torch.equal(
                            Y, launch(lib, i, W, X)))}
                    row = {"storage": p, "B": B, "config": config,
                           "rel_err": rel_err(Y, ref),
                           "max_abs_err": float((Y - ref).abs().max()),
                           "card": card}
                    if not args.probe:
                        checks["wrapper_bits"] = bool(torch.equal(Y, wrapper))
                        Ws, Xs = operands(300, 132, B + 3, p, seed=B)
                        checks["ragged"] = bool(torch.allclose(
                            launch(lib, i, Ws, Xs),
                            streaming_matvec_ref(Ws, Xs), **TIGHT))
                        row["flushed_us"] = cuda_ms_cold(
                            torch, lambda: launch(lib, i, W, X),
                            flush) * 1e3
                        row["warm_us"] = cuda_ms(
                            torch, lambda: launch(lib, i, W, X)) * 1e3
                        row.update(timed)
                    row["checks"] = checks
                    ok = all(checks.values())
                    failed += not (ok or args.probe)
                    n_runs += 1
                    out.write(json.dumps(row) + "\n")
                    desc = " ".join(f"{k}{v}" for k, v in config.items())
                    line = (f"  {p} B={B} {desc}"
                            + (" (the kernel's)" if not args.probe and
                               tuple(config.values()) == chosen else "")
                            + f": relative error {row['rel_err']:.3e}, "
                            f"TIGHT {'met' if checks['plain'] else 'MISSED'}")
                    if not args.probe:
                        line += (f"; {row['flushed_us']:.2f} us flushed, "
                                 f"{row['warm_us']:.2f} us warm"
                                 + "".join(f"; {k} {v:.4g}"
                                           for k, v in timed.items()))
                    if not ok:
                        line += f"; checks {checks}"
                    print(line, flush=True)
    print(f"{n_runs} runs, {failed} failed; {card}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
