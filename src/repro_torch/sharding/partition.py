"""Logical-axis sharding rules (MaxText-style) over the port's mesh.

The counterpart of ``repro.sharding.partition``.  Every parameter and
activation of the model code carries *logical* axis names
(``ParamSpec.logical``); the rule tables map them onto the axes of a
:class:`~repro_torch.launch.mesh.Mesh`:

* tensor parallelism over ``model``  (heads / mlp / experts / vocab)
* FSDP over ``data``                 (the ``embed`` axis of weights)
* data parallelism over ``pod`` x ``data`` for activations
* multi-pod weight sharding adds ``pod`` to the FSDP axis.

The active mesh and rules are thread-local, set by the launchers through
:func:`set_mesh` or :func:`use_mesh`; without a mesh every annotation is
a no-op.  One process drives the mesh (``launch/mesh.py``), so outside a
``shard_map`` region values are global tensors: a GSPMD sharding
constraint changes where a value lives, never the value, and
:func:`shard` returns its argument.  The one region the model code writes
per mesh position is the expert-parallel MoE (``models/moe_ep.py``), which
reads the active mesh and rules from here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch

from repro_torch.core.fabric_matvec import P, _names
from repro_torch.launch.mesh import Mesh

__all__ = ["DEFAULT_RULES", "MULTIPOD_RULES", "INFERENCE_RULES",
           "INFERENCE_MULTIPOD_RULES", "NamedSharding", "set_mesh",
           "current_mesh", "current_rules", "use_mesh", "logical_to_pspec",
           "shard", "is_logical_axes", "param_shardings", "fitted_pspec",
           "fitted_shardings"]

# logical axis -> mesh axis (or tuple of axes, or None = replicated)
DEFAULT_RULES: dict[str, object] = {
    # weights
    "embed": "data",            # FSDP shard of the d_model axis of weights
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",
    "mlp": "model",
    "experts": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "head_dim": None,
    # activations
    "batch": "data",
    "act_seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_experts": "model",
    "expert_capacity": None,
    "vision_seq": None,
    "kv_seq": "model",          # decode KV cache: sequence-sharded
}

# Multi-pod: batch over (pod, data); FSDP over (pod, data) as well.
MULTIPOD_RULES: dict[str, object] = dict(
    DEFAULT_RULES,
    embed=("pod", "data"),
    batch=("pod", "data"),
)

# Inference (prefill / decode): weight-stationary, no FSDP axis on
# weights, so a serve step gathers no parameters.
INFERENCE_RULES: dict[str, object] = dict(DEFAULT_RULES, embed=None)
INFERENCE_MULTIPOD_RULES: dict[str, object] = dict(
    MULTIPOD_RULES, embed=None)

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout of a global tensor over ``mesh`` by ``spec``.  The port
    keeps parameters as global tensors on the mesh's home device
    (position 0's); :meth:`place` checks that the tensor splits as the
    spec says and puts it there."""
    mesh: Mesh
    spec: P

    @property
    def device(self) -> torch.device:
        return self.mesh.device_list[0]

    def check(self, shape) -> None:
        """Raise ``ValueError`` unless every dimension of ``shape`` splits
        evenly over the mesh axes its spec entry names."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"shape {tuple(shape)} has dimensions")
        for dim, (size, part) in enumerate(zip(shape, self.spec)):
            count = math.prod(self.mesh.shape[a] for a in _names(part))
            if size % count:
                raise ValueError(f"dim {dim} of size {size} does not split "
                                 f"over {count} shards ({part}) of "
                                 f"{self.mesh!r}")

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The block of ``shape`` that one mesh position holds (JAX's
        ``NamedSharding.shard_shape``); raises as :meth:`check` does."""
        self.check(shape)
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(size // math.prod(self.mesh.shape[a]
                                       for a in _names(part))
                     for size, part in zip(shape, spec))

    def place(self, x: torch.Tensor) -> torch.Tensor:
        self.check(x.shape)
        return x.to(self.device)


def set_mesh(mesh: Mesh | None, rules: dict | None = None) -> None:
    _STATE.mesh = mesh
    _STATE.rules = rules if rules is not None else (
        MULTIPOD_RULES if mesh is not None and "pod" in mesh.axis_names
        else DEFAULT_RULES)


def current_mesh() -> Mesh | None:
    return getattr(_STATE, "mesh", None)


def current_rules() -> dict:
    return getattr(_STATE, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None, rules: dict | None = None):
    prev_mesh = current_mesh()
    prev_rules = current_rules()
    set_mesh(mesh, rules)
    try:
        yield
    finally:
        set_mesh(prev_mesh, prev_rules)


def logical_to_pspec(axes: tuple[str | None, ...],
                     rules: dict | None = None) -> P:
    """Each logical axis's mesh axes under ``rules``; a mesh axis is used
    once per spec (a later logical axis that maps to it is replicated)."""
    rules = rules or current_rules()
    phys = []
    used: set[str] = set()
    for a in axes:
        r = rules.get(a) if a is not None else None
        free = tuple(x for x in _names(r) if x not in used)
        used.update(free)
        phys.append(None if not free else
                    free if len(free) > 1 else free[0])
    return P(*phys)


def shard(x: torch.Tensor, axes: tuple[str | None, ...],
          rules: dict | None = None) -> torch.Tensor:
    """The JAX package's activation sharding constraint.  GSPMD's
    ``with_sharding_constraint`` changes a value's layout, never its
    value, and the port keeps global tensors outside ``shard_map``
    regions, so this returns ``x`` unchanged."""
    return x


def is_logical_axes(x) -> bool:
    """A logical-axes annotation: tuple of (str | None) — and NOT a
    named tuple container like ``OptState`` (which is also a tuple)."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def _map(fn, tree, *rest):
    """``fn`` over the logical-axes leaves of a dict tree (and the
    matching leaves of ``rest``)."""
    if is_logical_axes(tree):
        return fn(tree, *rest)
    return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def param_shardings(logical_tree, mesh: Mesh | None = None,
                    rules: dict | None = None):
    """Map a tree of logical-axis tuples to NamedShardings (or None)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return _map(lambda _: None, logical_tree)
    return _map(lambda axes: NamedSharding(mesh, logical_to_pspec(axes,
                                                                  rules)),
                logical_tree)


def fitted_pspec(shape: tuple[int, ...], axes: tuple[str | None, ...],
                 rules: dict | None = None) -> P:
    """Shape-aware sharding: like :func:`logical_to_pspec` but drops mesh
    axes that do not evenly divide the dimension (greedily keeps the
    prefix whose product divides; e.g. kv_heads = 8 on a 16-way model
    axis -> replicated)."""
    rules = rules or current_rules()
    mesh = current_mesh()
    sizes = dict(zip(mesh.axis_names, mesh.shape.values())) if mesh else {}
    phys = []
    used: set[str] = set()
    for dim, a in zip(shape, axes):
        r = rules.get(a) if a is not None else None
        kept = []
        prod = 1
        for x in _names(r):
            if x not in used and dim % (prod * sizes.get(x, 1)) == 0:
                kept.append(x)
                prod *= sizes.get(x, 1)
        used.update(kept)
        phys.append(None if not kept else
                    tuple(kept) if len(kept) > 1 else kept[0])
    return P(*phys)


def fitted_shardings(abstract_tree, logical_tree, mesh: Mesh,
                     rules: dict | None = None):
    """NamedShardings fitted to concrete shapes (params / inputs / caches):
    ``abstract_tree`` holds tensors (meta ones do) of the logical tree's
    structure.  The shapes are fitted against the active mesh's sizes, as
    in the JAX package."""
    return _map(lambda axes, t: NamedSharding(
        mesh, fitted_pspec(tuple(t.shape), axes, rules)),
        logical_tree, abstract_tree)
