"""The JAX side of the dry-run parity tests (``tests/test_torch_dryrun*.py``),
run as a script in a process of its own: importing ``repro.launch.dryrun``
sets ``XLA_FLAGS`` to 512 host devices, which must not reach a pytest
worker.  The smoke configs stand in for the full ones (``get_config`` is
patched to ``get_smoke_config``) unless a mode says otherwise.

    python tests/dryrun_jax.py flops ARCH:SHAPE,...
        per cell, compiled on a 1 x 1 mesh: ``dot_stats``' FLOPs and the
        same dots weighted through the whole call graph (``weighted``)
    python tests/dryrun_jax.py args ARCH:SHAPE,...
        per cell and production mesh (pod, multipod): the sum over the
        leaves of ``build_cell``'s specs of the shard size in bytes
    python tests/dryrun_jax.py memory ARCH:SHAPE,...
        per cell compiled on the pod mesh: that sum beside
        ``memory_analysis().argument_size_in_bytes``
    python tests/dryrun_jax.py full-args
        the shard-size sums of every full-width cell on both meshes,
        built and never compiled

Each prints one JSON object on its last line.
"""
from __future__ import annotations

import json
import math
import re
import sys

import repro.launch.dryrun as D  # noqa: E402  (sets XLA_FLAGS first)
import jax
from repro.configs import (ARCH_IDS, SHAPES, applicable_shapes, get_config,
                           get_smoke_config)
from repro.launch.mesh import make_mesh, make_production_mesh
from repro.sharding import partition as P_


def call_weights(hlo: str) -> tuple[dict, dict]:
    """Each computation's execution count from the entry down: a while
    body or condition runs its trip count per call, any other callee
    (``calls=``, ``to_apply=``, branches) once.  ``trip_multipliers``
    follows only the while nesting, so a dot fused into a computation
    that a while body calls keeps weight 1."""
    comps = D.parse_computations(hlo)
    entry = "%" + re.search(r"^ENTRY\s+%?([\w.\-]+)", hlo, re.M).group(1)
    edges: dict[str, list] = {}
    for name, lines in comps.items():
        for ln in lines:
            m = re.search(r"while\(.*?condition=%?([\w.\-]+),\s*"
                          r"body=%?([\w.\-]+)", ln)
            if m:
                cond, body = m.group(1), m.group(2)
                trip = 1
                for c in comps.get(cond, []):
                    k = re.search(r"constant\((\d+)\)", c)
                    if k:
                        trip = max(trip, int(k.group(1)))
                edges.setdefault(name, []).extend([(body, trip),
                                                   (cond, trip)])
                continue
            for m in re.finditer(r"(?:calls|to_apply)=%?([\w.\-]+)", ln):
                edges.setdefault(name, []).append((m.group(1), 1))
            m = re.search(r"branch_computations=\{([^}]*)\}", ln)
            if m:
                edges.setdefault(name, []).extend(
                    (b.strip().lstrip("%"), 1) for b in m.group(1).split(","))
    weights: dict[str, int] = {}

    def visit(name: str, w: int) -> None:
        weights[name] = weights.get(name, 0) + w
        for callee, trip in edges.get(name, []):
            visit(callee, w * trip)

    visit(entry, 1)
    return comps, weights


def weighted_dot_flops(hlo: str) -> float:
    """``dot_stats``' FLOPs with every computation weighted by
    :func:`call_weights`."""
    comps, weights = call_weights(hlo)
    total = 0.0
    for name, lines in comps.items():
        one = D.dot_stats("\n".join(["%c () -> f32[] {"] + lines))
        total += weights.get(name, 0) * one["dot_flops"]
    return total


def _rules(shape_name: str, multi: bool = False) -> dict:
    if SHAPES[shape_name].kind == "train":
        return P_.MULTIPOD_RULES if multi else P_.DEFAULT_RULES
    return P_.INFERENCE_MULTIPOD_RULES if multi else P_.INFERENCE_RULES


def shard_bytes(args) -> int:
    return sum(math.prod(s.sharding.shard_shape(s.shape)) * s.dtype.itemsize
               for s in jax.tree.leaves(args))


def _cells(arg: str) -> list[tuple[str, str]]:
    return [tuple(c.split(":")) for c in arg.split(",")]


def flops(cells) -> dict:
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    for arch, s in cells:
        with P_.use_mesh(mesh, _rules(s)):
            fn, args, _ = D.build_cell(arch, s, mesh)
            hlo = jax.jit(fn).lower(*args).compile().as_text()
        out[f"{arch}:{s}"] = {"dot_flops": D.dot_stats(hlo)["dot_flops"],
                              "weighted": weighted_dot_flops(hlo)}
    return out


def args_bytes(cells) -> dict:
    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch, s in cells:
            with P_.use_mesh(mesh, _rules(s, multi)):
                _, args, _ = D.build_cell(arch, s, mesh)
            out[f"{arch}:{s}:{'multipod' if multi else 'pod'}"] = \
                shard_bytes(args)
    return out


def memory(cells) -> dict:
    mesh = make_production_mesh()
    out = {}
    for arch, s in cells:
        with P_.use_mesh(mesh, _rules(s)):
            fn, args, _ = D.build_cell(arch, s, mesh)
            mem = jax.jit(fn).lower(*args).compile().memory_analysis()
        out[f"{arch}:{s}"] = {"shard_bytes": shard_bytes(args),
                              "argument_size_in_bytes":
                                  mem.argument_size_in_bytes}
    return out


def main() -> None:
    mode = sys.argv[1]
    if mode == "full-args":
        out = args_bytes([(a, s) for a in ARCH_IDS
                          for s in applicable_shapes(get_config(a))])
    else:
        D.get_config = get_smoke_config
        out = {"flops": flops, "args": args_bytes,
               "memory": memory}[mode](_cells(sys.argv[2]))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
