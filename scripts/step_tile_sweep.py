#!/usr/bin/env python3
"""Candidate configurations of the PageRank step core (K1 and K4) on one
CUDA card.

Run from the repository root:

    python3 scripts/step_tile_sweep.py [--parent DIR] [--out FILE]

``src/repro_torch/kernels/csrc/pagerank_step.cu`` runs the fused step (K1)
and the unpadded step (K4) on one row-streaming core whose configuration
``Cfg<R, D>`` is R rows per warp and a register ring D steps deep;
``Chosen`` there picks one per storage type.  This script
instantiates the candidates below from that same source (one translation
unit per storage type that includes it, built with ``nvcc`` into
``build/step_tile_sweep/``, all in parallel) and, for each storage type:

* K4 on the 5000 x 5000 H of ``ops.pagerank_iteration``'s loop and K1 on
  the 5120 x 5120 padded layout (int8 with its row scales): each
  candidate against the plain version (rtol 1e-5 / atol 5e-5 and rtol
  1e-5 / atol 1e-9), two launches bit-identical, and K4 also on ragged
  shapes (7 x 130, 300 x 5001, and 300 x 136 at an element offset, which
  take the peeled path); then its time with the L2 flushed before the call
  and back to back, as ``chip_smoke.py`` times the kernels, beside
  ``torch.addmv`` (f32) and a PyTorch reduction that reads the same bytes
  of H once (``torch.sum`` over them as float32).  The chosen
  configuration and that reduction are also timed after an L2 eviction
  that leaves no dirty line (a read of 256 MiB instead of a write), which
  shows what the written-back flush costs a flushed call.  First, both
  wrappers are timed at a tiny shape (7 x 130 and 8 x 512, f32), which is
  what a call costs beyond its bytes.
* ``--parent DIR``: also builds ``DIR``'s ``pagerank_step.cu`` (an
  unpacked earlier commit: K4's C entry with or without the ``vec``
  argument of the design before this core) and times its K1 and K4 the
  same way in the same run, before and after the candidates, with the
  chosen configuration timed twice between them.

It prints one line per run and writes them as JSON lines to ``--out``
(default ``build/step_tile_sweep/tiles.jsonl``).  It needs a card and the
CUDA toolkit; without a card it exits non-zero, and it exits 1 if a
candidate fails a check.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (TIGHT, TOL32, capture, cuda_ms,  # noqa: E402
                        cuda_ms_cold, k2_case, nvidia_smi, ptxas_report,
                        random_case, step_instantiations)

PRECISIONS = ("f32", "bf16", "f16", "int8")
TYPES = {"f32": "float", "bf16": "__nv_bfloat16", "f16": "__half",
         "int8": "int8_t"}
SOURCE = Path("src") / "repro_torch" / "kernels" / "csrc" / \
    "pagerank_step.cu"
# (R, D): rows per warp (R divides the CTA's 8 rows), ring depth
CANDIDATES = [(4, 4), (4, 2), (4, 8), (2, 4), (2, 8), (8, 2), (8, 4),
              (1, 8)]
KEYS = ("R", "D")
K4_SHAPE, K1_SHAPE, DAMPING = (5000, 5000), (5120, 5120), 0.85
# K4's ragged checks: N below the SM count, a row pitch that is not a
# multiple of 16 bytes, and H at an element offset (the peeled path)
RAGGED = ((7, 130, 0), (300, 5001, 0), (300, 136, 1))


def translation_unit(ctype: str) -> str:
    """The kernel source with ``sweep_k1(i, ...)`` and ``sweep_k4(i, ...)``
    that launch candidate i for storage ``ctype``."""
    k1 = "\n".join(
        f"    case {i}: return static_cast<int>(launch_fused<{ctype}, "
        f"Cfg<{r}, {d}>>(H, X, DG, T, S, Y, P, LK, Np, Mp, d, st));"
        for i, (r, d) in enumerate(CANDIDATES))
    k4 = "\n".join(
        f"    case {i}: return static_cast<int>(launch_unpadded<{ctype}, "
        f"Cfg<{r}, {d}>>(H, X, T, Y, N, M, d, st));"
        for i, (r, d) in enumerate(CANDIDATES))
    return f'''#include "{ROOT / SOURCE}"

#define F(p) static_cast<const float*>(p)
extern "C" int sweep_k1(int i, const void* H, const void* x,
                        const void* dang, const void* t, const void* s,
                        void* y, void* p, void* leak, int Np, int Mp,
                        float d, void* stream) {{
  const float *X = F(x), *DG = F(dang), *T = F(t), *S = F(s);
  float *Y = static_cast<float*>(y), *P = static_cast<float*>(p),
        *LK = static_cast<float*>(leak);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (i) {{
{k1}
    default: return -1;
  }}
}}

extern "C" int sweep_k4(int i, const void* H, const void* x, const void* t,
                        void* y, int N, int M, float d, void* stream) {{
  const float *X = F(x), *T = F(t);
  float* Y = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (i) {{
{k4}
    default: return -1;
  }}
}}
'''


def build(parent: Path | None):
    """The candidates' libraries (one per storage type) and the parent's,
    all built at once; returns them and each candidate's ptxas report."""
    from repro_torch.kernels import _build
    out = _build.BUILD_ROOT.parent / "step_tile_sweep"
    out.mkdir(parents=True, exist_ok=True)
    units = {}
    for p, ctype in TYPES.items():
        (out / f"step_{p}.cu").write_text(translation_unit(ctype))
        units[p] = (out / f"step_{p}.cu", out / f"libstep_{p}.so")
    if parent is not None:
        units["parent"] = (parent / SOURCE, out / "libparent.so")
    t0 = time.perf_counter()
    logs = _build.compile_units(units)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    regs = {}
    for p in TYPES:
        for key, info in step_instantiations(logs[p]).items():
            regs[key] = info
    for name, log in logs.items():
        for fn, info in ptxas_report(log).items():
            if info.get("spill_stores") or info.get("spill_loads"):
                print(f"  {name}: {fn} spills {info}")
    k1_args = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    k4_args = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    libs = {}
    for p in TYPES:
        lib = ctypes.CDLL(str(units[p][1]))
        lib.sweep_k1.argtypes = k1_args
        lib.sweep_k4.argtypes = k4_args
        libs[p] = lib
    parent_lib = None
    if parent is not None:
        parent_lib = ctypes.CDLL(str(units["parent"][1]))
        parent_lib.pagerank_step_fused_launch.argtypes = [ctypes.c_int] + \
            [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p]
        # the design before this core took a ``vec`` flag before the stream
        parent_lib.vec = not hasattr(parent_lib, "pagerank_step_config")
        parent_lib.pagerank_step_launch.argtypes = [ctypes.c_int] + \
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float] + \
            [ctypes.c_int] * parent_lib.vec + [ctypes.c_void_p]
    return libs, parent_lib, regs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="an unpacked earlier commit to time beside")
    parser.add_argument("--out", default=str(
        ROOT / "build" / "step_tile_sweep" / "tiles.jsonl"))
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("step_tile_sweep: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import pagerank_step as k1
    from repro_torch.kernels.ref import (pagerank_step_fused_ref,
                                         pagerank_step_ref)

    card = nvidia_smi()
    print(f"card: {card}")
    libs, parent_lib, regs = build(args.parent)
    lib0 = k1._library()
    lib0.pagerank_step_config.argtypes = (ctypes.c_int, ctypes.c_void_p)

    def chosen(p):
        out = (ctypes.c_int * len(KEYS))()
        lib0.pagerank_step_config(PRECISIONS.index(p), out)
        return tuple(out)

    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    store = {"f32": torch.float32, "bf16": torch.bfloat16,
             "f16": torch.float16, "int8": torch.int8}
    rows_per_cta = k1.ROWS_PER_CTA

    def k4_operands(n, m, p, seed, offset=0):
        W, X = k2_case(np, n, m, 1, p, seed=seed)
        Wt = torch.from_numpy(W)
        if p != "int8":
            Wt = Wt.to(store[p])
        if offset:
            flat = torch.empty(n * m + offset, dtype=Wt.dtype, device=dev)
            H = flat[offset:].view(n, m)
            H.copy_(Wt.to(dev))
        else:
            H = Wt.to(dev)
        return H, torch.from_numpy(X[0]).to(dev), torch.tensor(
            0.15 / n, device=dev)

    def k1_operands(p, seed):
        H, x, dang, t, scales, _ = random_case(np, *K1_SHAPE, p, seed=seed)
        Ht = torch.from_numpy(H).to(dev)
        if p != "int8":
            Ht = Ht.to(store[p])
        return (Ht, torch.from_numpy(x).to(dev),
                torch.from_numpy(dang).to(dev), torch.tensor(t, device=dev),
                None if scales is None else torch.from_numpy(scales).to(dev))

    def k4_launch(lib, i, H, x, t):
        y = torch.empty(H.shape[0], device=dev)
        a = (H.data_ptr(), x.data_ptr(), t.data_ptr(), y.data_ptr(),
             H.shape[0], H.shape[1], DAMPING)
        if i is None:      # the parent's entry, vec as its wrapper set it
            vec = int(H.shape[1] % 4 == 0
                      and H.data_ptr() % (4 * H.element_size()) == 0
                      and x.data_ptr() % 16 == 0)
            err = lib.pagerank_step_launch(
                PRECISIONS.index(next(q for q, v in store.items()
                                      if v == H.dtype)), *a,
                *([vec] if lib.vec else []), stream())
        else:
            err = lib.sweep_k4(i, *a, stream())
        if err:
            raise RuntimeError(f"K4 candidate {i}: cudaError_t {err}")
        return y

    def k1_launch(lib, i, ops):
        H, x, dang, t, scales = ops
        Np, Mp = H.shape
        y = torch.empty((1, Np), device=dev)
        part = torch.empty(Np // rows_per_cta, device=dev)
        leak = torch.empty((), device=dev)
        a = (H.data_ptr(), x.data_ptr(), dang.data_ptr(), t.data_ptr(),
             None if scales is None else scales.data_ptr(), y.data_ptr(),
             part.data_ptr(), leak.data_ptr(), Np, Mp, DAMPING, stream())
        if i is None:
            err = lib.pagerank_step_fused_launch(
                PRECISIONS.index(next(q for q, v in store.items()
                                      if v == H.dtype)), *a)
        else:
            err = lib.sweep_k1(i, *a)
        if err:
            raise RuntimeError(f"K1 candidate {i}: cudaError_t {err}")
        return y, leak

    def flushed(fn):
        return cuda_ms_cold(torch, fn, flush) * 1e3

    def flushed_clean(fn, samples=21):
        """As ``flushed``, the L2 evicted by a read of the 256 MiB."""
        graph = capture(torch, fn, 1)
        words = flush.view(torch.float32)
        times = []
        for _ in range(samples):
            words.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times) * 1e3

    def warm(fn):
        return cuda_ms(torch, fn) * 1e3

    def rel_err(y, ref):
        return float(((y - ref).abs() / ref.abs()).max())

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    failed = n_runs = 0
    with open(args.out, "w") as out:
        def emit(row, line):
            out.write(json.dumps(dict(row, card=card)) + "\n")
            print(line, flush=True)

        # what a call costs beyond its bytes: the wrappers' launches at a
        # tiny shape (f32), flushed and back to back, beside the parent's
        tiny4 = k4_operands(7, 130, "f32", seed=1)
        tiny1 = (torch.rand((rows_per_cta, 512), device=dev),
                 torch.rand((1, 512), device=dev),
                 torch.zeros((1, rows_per_cta), device=dev),
                 torch.tensor(1e-4, device=dev), None)
        tiny = {"K4 7x130": lambda: k1.pagerank_step(*tiny4, d=DAMPING),
                f"K1 {rows_per_cta}x512": lambda: k1.pagerank_step_fused(
                    *tiny1[:4], d=DAMPING)}
        if parent_lib is not None:
            tiny["parent K4 7x130"] = lambda: k4_launch(parent_lib, None,
                                                        *tiny4)
            tiny[f"parent K1 {rows_per_cta}x512"] = lambda: k1_launch(
                parent_lib, None, tiny1)
        for name, fn in tiny.items():
            row = {"kernel": "tiny", "which": name,
                   "flushed_us": flushed(fn), "warm_us": warm(fn)}
            emit(row, f"  {name} (f32): {row['flushed_us']:.2f} us "
                 f"flushed, {row['warm_us']:.2f} warm")
        for p in PRECISIONS:
            pick = chosen(p)
            k4_ops = k4_operands(*K4_SHAPE, p, seed=sum(K4_SHAPE))
            k1_ops = k1_operands(p, seed=sum(K1_SHAPE))
            H4, x4, t4 = k4_ops
            H1 = k1_ops[0]
            k4_ref = pagerank_step_ref(H4, x4, t4, d=DAMPING)
            k1_ref = pagerank_step_fused_ref(*k1_ops, d=DAMPING)
            ragged = [(k4_operands(n, m, p, seed=n + m, offset=off), off)
                      for n, m, off in RAGGED]
            # yardsticks: torch.addmv (f32) and one read of H's bytes
            yard = {}
            for name, H, x, t in (("K4", H4, x4, t4),
                                  ("K1", H1, k1_ops[1][0], k1_ops[3])):
                words = H.view(torch.float32)
                yard[name] = {
                    "read_us": flushed(lambda w=words: w.sum()),
                    "read_clean_us": flushed_clean(lambda w=words: w.sum())}
                if p == "f32":
                    tv = t.expand(H.shape[0]).contiguous()
                    yard[name]["addmv_us"] = flushed(
                        lambda H=H, x=x, tv=tv: torch.addmv(
                            tv, H, x, alpha=DAMPING))
            parent_us = {"K4": [], "K1": []}

            def time_parent():
                if parent_lib is None:
                    return
                parent_us["K4"].append(flushed(
                    lambda: k4_launch(parent_lib, None, *k4_ops)))
                parent_us["K1"].append(flushed(
                    lambda: k1_launch(parent_lib, None, k1_ops)))

            time_parent()
            order = list(enumerate(CANDIDATES))
            i_pick = CANDIDATES.index(pick)
            # the chosen configuration first and last, the others between
            order = ([(i_pick, pick)] + [o for o in order if o[0] != i_pick]
                     + [(i_pick, pick)])
            for n_seen, (i, cand) in enumerate(order):
                again = n_seen == len(order) - 1
                config = dict(zip(KEYS, cand))
                desc = " ".join(f"{k}{v}" for k, v in config.items())
                lib = libs[p]
                # K4
                y = k4_launch(lib, i, *k4_ops)
                torch.cuda.synchronize()
                checks = {
                    "plain": bool(torch.allclose(y, k4_ref, **TOL32)
                                  and torch.allclose(y, k4_ref, **TIGHT)),
                    "repeat_bits": bool(torch.equal(
                        y, k4_launch(lib, i, *k4_ops)))}
                for (Hr, xr, tr), off in ragged:
                    yr = k4_launch(lib, i, Hr, xr, tr)
                    checks[f"ragged_{tuple(Hr.shape)}_{off}"] = bool(
                        torch.allclose(yr, pagerank_step_ref(
                            Hr, xr, tr, d=DAMPING), **TIGHT))
                if cand == pick:
                    checks["wrapper_bits"] = bool(torch.equal(
                        y, k1.pagerank_step(H4, x4, t4, d=DAMPING)))
                row = {"kernel": "K4", "storage": p, "config": config,
                       "chosen": cand == pick, "repeat": again,
                       "shape": list(K4_SHAPE),
                       "rel_err": rel_err(y, k4_ref),
                       "flushed_us": flushed(
                           lambda: k4_launch(lib, i, *k4_ops)),
                       "warm_us": warm(lambda: k4_launch(lib, i, *k4_ops)),
                       "ptxas": regs.get(("K4", p, cand, True)),
                       "checks": checks, **yard["K4"]}
                if cand == pick:
                    row["flushed_clean_us"] = flushed_clean(
                        lambda: k4_launch(lib, i, *k4_ops))
                ok = all(checks.values())
                failed += not ok
                n_runs += 1
                emit(row, f"  K4 {p} {desc}"
                     + (" (chosen)" if cand == pick else "")
                     + f": {row['flushed_us']:.2f} us flushed, "
                     + (f"{row['flushed_clean_us']:.2f} clean, "
                        if "flushed_clean_us" in row else "")
                     + f"{row['warm_us']:.2f} warm; relative error "
                     f"{row['rel_err']:.3e}; {row['ptxas']}"
                     + ("" if ok else f"; FAILED {checks}"))
                # K1
                y1, leak = k1_launch(lib, i, k1_ops)
                torch.cuda.synchronize()
                y2, leak2 = k1_launch(lib, i, k1_ops)
                checks = {
                    "plain": bool(torch.allclose(y1, k1_ref[0], **TOL32)
                                  and torch.allclose(y1, k1_ref[0], **TIGHT)
                                  and torch.allclose(leak, k1_ref[1],
                                                     **TIGHT)),
                    "repeat_bits": bool(torch.equal(y1, y2)
                                        and torch.equal(leak, leak2))}
                if cand == pick:
                    wy, wl = k1.pagerank_step_fused(*k1_ops, d=DAMPING)
                    checks["wrapper_bits"] = bool(
                        torch.equal(wy, y1) and torch.equal(wl, leak))
                row = {"kernel": "K1", "storage": p, "config": config,
                       "chosen": cand == pick, "repeat": again,
                       "shape": list(K1_SHAPE),
                       "rel_err": rel_err(y1, k1_ref[0]),
                       "flushed_us": flushed(
                           lambda: k1_launch(lib, i, k1_ops)),
                       "warm_us": warm(lambda: k1_launch(lib, i, k1_ops)),
                       "ptxas": regs.get(("K1", p, cand, p == "int8")),
                       "checks": checks, **yard["K1"]}
                if cand == pick:
                    row["flushed_clean_us"] = flushed_clean(
                        lambda: k1_launch(lib, i, k1_ops))
                ok = all(checks.values())
                failed += not ok
                n_runs += 1
                emit(row, f"  K1 {p} {desc}"
                     + (" (chosen)" if cand == pick else "")
                     + f": {row['flushed_us']:.2f} us flushed, "
                     + (f"{row['flushed_clean_us']:.2f} clean, "
                        if "flushed_clean_us" in row else "")
                     + f"{row['warm_us']:.2f} warm; relative error "
                     f"{row['rel_err']:.3e}; {row['ptxas']}"
                     + ("" if ok else f"; FAILED {checks}"))
            time_parent()
            summary = {"kernel": "yardsticks", "storage": p, **{
                f"{k}_{n}": v for k, d_ in yard.items()
                for n, v in d_.items()}}
            if parent_lib is not None:
                summary["parent_us"] = parent_us
            emit(summary, f"  {p}: " + ", ".join(
                f"{k} {v}" for k, v in summary.items()
                if k not in ("kernel", "storage")))
    print(f"{n_runs} runs, {failed} failed; {card}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
