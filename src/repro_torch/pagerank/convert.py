"""Carry a prepared layout across from numpy arrays.

The state of this system is the prepared layout and the host edge
bookkeeping beside it.  :func:`layout_from_numpy` takes a layout as numpy
arrays — for instance the JAX engine's ``eng.operands``, its ``_scales``
and its dangling mask, each through ``np.asarray``, and optionally its
sorted edge keys ``_keys`` and degree vectors ``_outdeg`` / ``_indeg`` —
and returns the port's operand tensors (the bookkeeping stays numpy),
which :meth:`repro_torch.pagerank.engine.PageRankEngine.from_layout` wraps
in an engine; a :class:`~repro_torch.pagerank.landmarks.LandmarkIndex`
needs the bookkeeping.  numpy has no native bfloat16: a bfloat16 array
(numpy's ``ml_dtypes`` extension type, as JAX hands it out) is carried
through float32, which is exact for bfloat16 values.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fabric_matvec import P, ShardedTensor
from repro_torch.graph.sparse import BSRMatrix
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.pagerank.engine import BACKENDS, SHARDED_BACKENDS
from repro_torch.pagerank.precision import STORAGE_DTYPES, resolve_precision

__all__ = ["layout_from_numpy"]

# positions of the value arrays (stored in the precision's dtype) in each
# backend's operand tuple; the other positions are int32 indices, the
# dangling mask, or the float32 int8 scales
_VALUE_SLOTS = {"dense": (0,), "ell": (0, 4), "bsr": (0,),
                "fused_dense": (0,), "dense_sharded": (0,),
                "ell_sharded": (0,)}
_N_OPERANDS = {"dense": (1, 2), "ell": (5, 6), "bsr": (2, 3),
               "fused_dense": (2, 2), "dense_sharded": (1, 1),
               "ell_sharded": (2, 2)}
# the sharded tiers take their int8 scales separately, as the fused tier
_SEPARATE_SCALES = ("fused_dense", "dense_sharded", "ell_sharded")


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # np.asarray of a JAX array is read-only: copy before from_numpy
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def layout_from_numpy(backend: str, arrays: dict, *, precision: str,
                      device: str | torch.device | None = None,
                      mesh: Mesh | None = None) -> dict:
    """``arrays`` holds ``operands`` (the operand tuple of ``backend``),
    ``scales`` (the fused and sharded tiers' int8 scales, or ``None``) and
    ``dang`` (the (n,) dangling mask, padded on the sharded tiers), and
    optionally the host edge bookkeeping ``keys`` (sorted src*n+dst),
    ``outdeg`` and ``indeg``.  Returns the first three as tensors on
    ``device``, value arrays in the precision's storage dtype, and the
    bookkeeping as int64 numpy arrays (``None`` where not given).  int8
    layouts of ``dense`` and ``ell`` carry their scales as the last
    operand, as in the JAX package.  For ``bsr`` the operands are the
    container's arrays in its pytree order (``blocks``, ``block_cols``, and
    ``row_scales`` for int8), and the returned operands hold one
    :class:`BSRMatrix`.  The sharded tiers take the global arrays (what
    ``np.asarray`` gives of a JAX sharded array) and a ``mesh``, and cut
    them over it in the engine's layouts; the result carries the mesh."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend not in _N_OPERANDS:
        raise ValueError(f"{backend} has no counterpart in the JAX package "
                         "to carry a layout from")
    precision = resolve_precision(precision)
    sharded = backend in SHARDED_BACKENDS
    if sharded and mesh is None:
        raise ValueError(f"{backend} needs a mesh")
    dev = mesh.device_list[0] if sharded else resolve_device(device)
    ops = tuple(arrays["operands"])
    lo, hi = _N_OPERANDS[backend]
    want = hi if precision == "int8" else lo
    if len(ops) != want:
        raise ValueError(f"{backend} at {precision} takes {want} operands, "
                         f"got {len(ops)}")
    tensors = tuple(_tensor(a, dev) for a in ops)
    storage = STORAGE_DTYPES[precision]
    for slot in _VALUE_SLOTS[backend]:
        if tensors[slot].dtype != storage:
            raise ValueError(f"operand {slot} is {tensors[slot].dtype}, "
                             f"{precision} stores {storage}")
    scales = arrays.get("scales")
    if backend in _SEPARATE_SCALES and (scales is not None) != (
            precision == "int8"):
        raise ValueError(f"{backend} takes scales exactly for int8")
    scales = None if scales is None else _tensor(scales, dev)
    dang = _tensor(arrays["dang"], dev).to(torch.float32)
    if sharded:
        axes = tuple(mesh.axis_names)
        spec = P(*axes) if backend == "dense_sharded" else P(axes)
        tensors = tuple(ShardedTensor.from_global(t, mesh, spec)
                        for t in tensors)
        dang = ShardedTensor.from_global(dang, mesh, P())
        if scales is not None:
            scales = ShardedTensor.from_global(
                scales, mesh, P() if backend == "dense_sharded" else spec)
    if backend == "bsr":
        n = dang.shape[0]
        tensors = (BSRMatrix(tensors[0], tensors[1], shape=(n, n),
                             row_scales=(tensors[2] if len(tensors) == 3
                                         else None)),)
    book = {k: None if arrays.get(k) is None
            else np.array(arrays[k], np.int64, copy=True)
            for k in ("keys", "outdeg", "indeg")}
    return {"operands": tensors, "scales": scales, "dang": dang,
            "mesh": mesh if sharded else None, **book}
