"""Multi-pod dry run on meta tensors: run every (architecture x input
shape) cell on the production mesh without allocating anything, prove it
fits, and count the roofline terms.

The counterpart of ``repro.launch.dryrun``.  Per cell this module:

  1. builds the production mesh (16 x 16 single-pod / 2 x 16 x 16
     multi-pod) of ``"meta"`` positions;
  2. builds meta tensors for the parameters (the float32 master copy for
     training, ``cfg.dtype`` for serving), the optimizer state, the cache
     and the batch, and a :class:`ArgSpec` per leaf in the JAX layout
     with a sharding fitted to its shape by the logical-axis rules;
  3. runs the production step (``train_step`` / ``prefill`` /
     ``decode_step``) once on them under the mesh.  The run takes the
     place of ``.lower().compile()``: a shape mismatch, a sharding that
     does not split, or a ``moe_ep`` divisibility error fails the cell;
  4. writes what that run counted into the JAX artifact's JSON record.

No environment variable is set and no device is touched: a meta tensor
has a shape and a dtype and no data.

There is no HLO, so ``_shape_bytes``, ``parse_computations``,
``trip_multipliers`` and ``_first_dims`` have no counterpart.  The port's
layer stacks are Python loops: every product is dispatched, and counted,
as many times as it runs, so no ``while`` body needs weighting.  The
counters:

* :class:`DispatchCounter` sees every ATen op of the run (the backward
  and remat's recompute included).  :func:`dot_stats` reads its
  matrix products by JAX's rule, ``2 x`` the result's elements ``x`` the
  contracted size, with the operand and result bytes; it counts no
  convolution and no attention rule.  It also tracks the live bytes of
  the storages the run makes.
* :func:`collective_stats` reads ``core.fabric_matvec``'s counts of the
  collectives the run issued, under JAX's HLO names and wire factors.

The scope of each number in the record:

* ``memory.argument_bytes`` and ``memory.output_bytes`` are per device:
  each leaf's shard under its sharding (the JAX dry run's argument bytes
  are the same shard sizes).  Outputs that are arguments written in place
  (the parameters and moments, the decode cache) take their argument's
  sharding, a prefill cache the fitted cache layout, the logits
  ``("batch", "vocab")``, the metrics none (replicated).
* ``dots``, ``cost.flops``, ``memory.temp_bytes`` and
  ``memory.peak_bytes`` are global: on the single-controller mesh every
  layer but ``moe_ep`` computes global tensors, so these are the whole
  step's, not one device's.  ``temp_bytes`` is the peak of the storages
  the run made and held at once; ``peak_bytes`` adds the arguments'
  global bytes.  ``cost.flops`` is the dot FLOPs.
* ``collectives`` are ``moe_ep``'s only (GSPMD's own collectives, such as
  the FSDP gathers of the dense layers, have no counterpart here);
  ``bytes`` sums what the participating positions put in and
  ``wire_bytes`` scales it by JAX's ring factor.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --mesh pod,multipod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import (ARCH_IDS, SHAPES, applicable_shapes,
                                 get_config)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import fabric_matvec
from repro_torch.data.pipeline import input_specs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import build_tree
from repro_torch.sharding import partition as P_
from repro_torch.train.optimizer import OptimizerConfig, OptState
from repro_torch.train.train_step import train_step
from repro_torch.train.tree import leaves, zeros_like

__all__ = ["ArgSpec", "spec_leaves", "DispatchCounter", "dot_stats",
           "collective_stats", "meta_params", "cell_rules", "build_cell",
           "Measured", "measure", "run_cell", "main"]

aten = torch.ops.aten

# the port's collectives under the JAX HLO names
HLO_NAME = {"psum": "all-reduce", "psum_masked": "all-reduce",
            "all_gather": "all-gather", "psum_scatter": "reduce-scatter",
            "reshard": "all-to-all"}
# per-device wire-byte multiplier (ring algorithms), JAX's
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# matrix products: op -> (lhs, rhs) argument positions; the contraction
# is the lhs's last dimension in every one
_DOTS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.mv: (0, 1),
         aten.dot: (0, 1), aten.addmm: (1, 2), aten.baddbmm: (1, 2),
         aten.addmv: (1, 2)}


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """One argument leaf in the JAX layout (stacks as leading
    dimensions): the counterpart of ``jax.ShapeDtypeStruct`` with a
    sharding."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: P_.NamedSharding

    @property
    def nbytes(self) -> int:
        return _nbytes(self.shape, self.dtype)

    @property
    def shard_nbytes(self) -> int:
        return _nbytes(self.sharding.shard_shape(self.shape), self.dtype)


def spec_leaves(tree) -> list[ArgSpec]:
    """The :class:`ArgSpec` leaves of a tree of dicts, tuples and lists
    (an ``OptState`` is a tuple)."""
    if isinstance(tree, ArgSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    return [x for t in tree for x in spec_leaves(t)]


class DispatchCounter(TorchDispatchMode):
    """Counts every ATen op dispatched while it is active (``n_ops``),
    the matrix products among them (``n_dots``, ``dot_flops``,
    ``dot_bytes``) and the live bytes of the storages the ops make
    (``live``, ``peak``).  Storages of :meth:`hold` (the arguments) are
    not counted as made."""

    def __init__(self):
        super().__init__()
        self.n_ops = 0
        self.n_dots = 0
        self.dot_flops = 0
        self.dot_bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: set[int] = set()

    def hold(self, tensors) -> None:
        for t in tensors:
            self._seen.add(t.untyped_storage()._cdata)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.n_ops += 1
        pair = _DOTS.get(func.overloadpacket)
        if pair is not None:
            a, b = args[pair[0]], args[pair[1]]
            self.n_dots += 1
            self.dot_flops += 2 * out.numel() * a.shape[-1]
            self.dot_bytes += sum(x.numel() * x.element_size()
                                  for x in (out, a, b))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


def dot_stats(counter: DispatchCounter) -> dict:
    """FLOPs and operand / result bytes of every matrix product the
    counter saw (global: the whole step's)."""
    return {"dot_flops": counter.dot_flops, "dot_bytes": counter.dot_bytes,
            "n_dots": counter.n_dots}


def collective_stats() -> dict:
    """The collectives counted in ``core.fabric_matvec`` since its last
    ``reset_counts``, by JAX HLO name: calls, bytes put in by the
    participating positions, and those bytes times JAX's wire factor."""
    out: dict[str, dict] = {}
    for kind, n in sorted(fabric_matvec.collectives.items()):
        op = HLO_NAME[kind]
        rec = out.setdefault(op, {"count": 0, "bytes": 0, "wire_bytes": 0})
        b = fabric_matvec.collective_bytes[kind]
        rec["count"] += n
        rec["bytes"] += b
        rec["wire_bytes"] += int(b * _WIRE_FACTOR[op])
    return out


def meta_params(cfg: ModelConfig, dtype: torch.dtype,
                trainable: bool = False) -> M.LanguageModel:
    """The parameter tree of ``cfg`` as meta tensors of ``dtype``, built
    as :func:`~repro_torch.models.model.init_params` builds it (which
    cannot run on meta: it draws from a generator on the device)."""
    return build_tree(M.param_specs(cfg),
                      lambda spec, path: torch.empty(spec.shape, dtype=dtype,
                                                     device="meta"),
                      into=M.LanguageModel(cfg), requires_grad=trainable)


def cell_rules(mesh: Mesh, kind: str) -> dict:
    """The rule table a step of ``kind`` runs under on ``mesh``."""
    pod = "pod" in mesh.axis_names
    if kind == "train":
        return P_.MULTIPOD_RULES if pod else P_.DEFAULT_RULES
    return P_.INFERENCE_MULTIPOD_RULES if pod else P_.INFERENCE_RULES


def _specs(tree, logical, mesh: Mesh, rules: dict, dtype=None):
    """An :class:`ArgSpec` per leaf of a tree of tensors (meta ones do),
    fitted to its shape; ``dtype`` overrides the leaves'."""
    return P_._map(lambda axes, t: ArgSpec(
        tuple(t.shape), dtype or t.dtype, P_.NamedSharding(
            mesh, P_.fitted_pspec(tuple(t.shape), axes, rules))),
        logical, tree)


def _batch_logical(batch: dict) -> dict:
    return {k: ("batch",) + (None,) * (v.dim() - 1) for k, v in batch.items()}


def build_cell(arch: str | ModelConfig, shape: str | ShapeConfig,
               mesh: Mesh, remat: str | None = None):
    """Returns ``(fn, args, specs)``: the step, its meta arguments and,
    parallel to them, their :class:`ArgSpec` trees in the JAX layout
    (what the JAX ``build_cell`` hands to ``lower``).  ``arch`` is an
    architecture name or a config; ``shape`` a shape name or a
    ``ShapeConfig``."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if remat:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    if isinstance(shape, str):
        shape = SHAPES[shape]
    rules = cell_rules(mesh, shape.kind)
    with P_.use_mesh(mesh, rules):
        logical = M.param_logical_axes(cfg)
        batch = input_specs(cfg, shape)
        batch_specs = _specs(batch, _batch_logical(batch), mesh, rules)

        if shape.kind == "train":
            params = meta_params(cfg, torch.float32, trainable=True)
            params_specs = _specs(M.abstract_params(cfg), logical, mesh,
                                  rules, torch.float32)
            step = torch.zeros((), dtype=torch.int32, device="meta")
            opt = OptState(step=step, m=zeros_like(params),
                           v=zeros_like(params), ef={})
            opt_specs = OptState(
                step=ArgSpec((), torch.int32, P_.NamedSharding(mesh, P_.P())),
                m=params_specs, v=params_specs, ef={})
            ocfg = OptimizerConfig()

            def fn(params, opt_state, batch):
                return train_step(params, opt_state, batch, cfg, ocfg)

            return fn, (params, opt, batch), (params_specs, opt_specs,
                                              batch_specs)

        # inference: cfg.dtype parameters, weight-stationary rules (no
        # FSDP axis on weights)
        params = meta_params(cfg, M.DTYPES[cfg.dtype])
        params_specs = _specs(M.abstract_params(cfg), logical, mesh, rules)
        if shape.kind == "prefill":
            def fn(params, batch):
                return M.prefill(params, batch, cfg, max_len=shape.seq_len)
            return fn, (params, batch), (params_specs, batch_specs)

        # decode: a cache of seq_len, one new token
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device="meta")
        cache_specs = _specs(cache, M.cache_logical_axes(cfg), mesh, rules)

        def fn(params, batch, cache):
            return M.decode_step(params, batch, cache, cfg)

        return fn, (params, batch, cache), (params_specs, batch_specs,
                                            cache_specs)


def _output_bytes(kind: str, out, specs, mesh: Mesh, rules: dict,
                  cfg: ModelConfig) -> int:
    """Per-device bytes of the step's outputs (module docstring)."""
    if kind == "train":                   # (params, opt_state, metrics)
        return (sum(s.shard_nbytes for s in spec_leaves(list(specs[:2])))
                + sum(t.numel() * t.element_size() for t in leaves(out[2])))
    logits, cache = out
    with P_.use_mesh(mesh, rules):
        if kind == "prefill":
            cache_specs = _specs(cache, M.cache_logical_axes(cfg), mesh,
                                 rules)
        else:                             # the argument, written in place
            cache_specs = specs[2]
        logit_spec = _specs({"logits": logits}, {"logits": ("batch",
                                                           "vocab")},
                            mesh, rules)
    return sum(s.shard_nbytes for s in spec_leaves([cache_specs,
                                                     logit_spec]))


@dataclasses.dataclass
class Measured:
    """What one run of a step counted: its output, wall seconds, the
    arguments' per-device bytes (from their specs) and global bytes (what
    the tensors hold), the :class:`DispatchCounter` and the collectives
    (:func:`collective_stats`)."""
    out: object
    run_s: float
    argument_bytes: int
    global_bytes: int
    counter: DispatchCounter
    collectives: dict


def measure(fn, args, specs, mesh: Mesh, rules: dict) -> Measured:
    """Run ``fn(*args)`` once under ``use_mesh(mesh, rules)`` and the
    counters (``core.fabric_matvec``'s counts are reset first).  The
    arguments may be meta tensors or real ones; their
    global bytes must equal their specs' (a shape or dtype that differs
    from the JAX layout fails here), and every spec must split over its
    mesh."""
    arg_leaves = leaves(list(args))
    arg_specs = spec_leaves(list(specs))
    got = sum(t.numel() * t.element_size() for t in arg_leaves)
    want = sum(s.nbytes for s in arg_specs)
    if got != want:
        raise ValueError(f"the arguments hold {got} bytes, their specs "
                         f"{want}")
    argument_bytes = sum(s.shard_nbytes for s in arg_specs)

    counter = DispatchCounter()
    counter.hold(arg_leaves)
    fabric_matvec.reset_counts()
    grad = any(t.requires_grad for t in arg_leaves)
    t0 = time.perf_counter()
    with P_.use_mesh(mesh, rules), torch.set_grad_enabled(grad), counter:
        out = fn(*args)
    return Measured(out, time.perf_counter() - t0, argument_bytes, got,
                    counter, collective_stats())


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str | None = None, save_hlo: bool = False,
             remat: str | None = None) -> dict:
    """One cell on the production mesh of ``"meta"`` positions; writes
    ``<arch>_<shape>_<mesh>.json`` under ``out_dir`` when given.
    ``save_hlo`` is accepted for the JAX flag and writes nothing (there
    is no HLO)."""
    multi = mesh_kind == "multipod"
    mesh = make_production_mesh(multi_pod=multi,
                                devices=["meta"] * (512 if multi else 256))
    shape = SHAPES[shape_name]
    rules = cell_rules(mesh, shape.kind)
    cfg = get_config(arch)
    fn, args, specs = build_cell(cfg, shape_name, mesh, remat=remat)
    m = measure(fn, args, specs, mesh, rules)
    counter = m.counter
    output_bytes = _output_bytes(shape.kind, m.out, specs, mesh, rules, cfg)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "n_devices": mesh.size,
        "status": "ok",
        "lower_s": round(m.run_s, 2), "compile_s": 0.0,
        "memory": {
            "argument_bytes": m.argument_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": counter.peak,
            "peak_bytes": m.global_bytes + counter.peak,
        },
        "cost": {"flops": float(counter.dot_flops)},
        "collectives": m.collectives,
        "dots": dot_stats(counter),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "n_ops": counter.n_ops,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}_{shape_name}_{mesh_kind}"
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="pod", help="pod,multipod")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--save-hlo", action="store_true",
                    help="accepted for the JAX flag; writes nothing")
    ap.add_argument("--remat", default=None,
                    help="override remat policy: full | dots | none")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    meshes = args.mesh.split(",")
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = (applicable_shapes(cfg) if args.shape == "all"
                  else args.shape.split(","))
        for shape_name in shapes:
            if shape_name not in applicable_shapes(cfg):
                print(f"SKIP {arch} x {shape_name} (inapplicable)")
                continue
            for mesh_kind in meshes:
                tag = f"{arch} x {shape_name} x {mesh_kind}"
                try:
                    r = run_cell(arch, shape_name, mesh_kind, args.out,
                                 args.save_hlo, remat=args.remat)
                    print(f"OK   {tag}: run={r['lower_s']}s "
                          f"flops={r['cost']['flops']:.3e} "
                          f"args={r['memory']['argument_bytes'] / 2**30:.2f}"
                          f"GiB/device", flush=True)
                except Exception as e:
                    failures.append(tag)
                    print(f"FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")


if __name__ == "__main__":
    main()
