"""The paper's fabric MV schedule mapped onto a device mesh.

The counterpart of ``repro.core.fabric_matvec``.  The R x C site grid of the
paper becomes a 2-D :class:`~repro_torch.launch.mesh.Mesh`, and its buses
become collectives:

* matrix stationary in the fabric      ->  A sharded ``P(row_axis, col_axis)``
* vector broadcast on the vertical bus ->  x sharded ``P(col_axis)``
  (replicated along the row axis)
* products summed on the horizontal bus -> :func:`psum` (or
  :func:`psum_scatter`) along ``col_axis``
* result in the adder column           ->  y sharded ``P(row_axis)``
* re-injection for iterative algorithms -> :func:`matvec_iterated_reshard`:
  on a square mesh a masked :func:`psum` along the row axis from the
  diagonal, otherwise a global :func:`reshard`.

One process drives the whole mesh.  A :class:`ShardedTensor` holds the
global shape, the ``PartitionSpec`` and one contiguous tensor per mesh
position on that position's device.  The collectives are written out:
each sums or concatenates the shards of a group in mesh order, so two
runs, and two positions on one device, give the same bits.  Positions on
one device whose inputs are the same tensors share one result (a mesh that
repeats a device computes each distinct block once), and each shard-local
product is one launch of the streaming kernel (K2,
:func:`repro_torch.kernels.streaming_matvec.streaming_matvec`) on a CUDA
tensor, its plain version on a CPU tensor; K2 upcasts bf16 / f16 / int8
shards in-register, as the site multiply does.

``collectives`` counts the calls of each collective and ``collective_bytes``
the bytes the participating positions put in (a masked ``psum`` counts the
kept shards, a ``reshard`` the shards that move); ``local_products``
counts the shard-local K2 calls by (storage type, batch size).  They are
the port's record of the schedule (``PageRankEngine.lower_run``).
"""
from __future__ import annotations

import functools
import itertools
import math
from collections import Counter

import numpy as np
import torch

from repro_torch.kernels.common import upcast_f32
from repro_torch.kernels.streaming_matvec import streaming_matvec
from repro_torch.launch.mesh import Mesh

__all__ = ["P", "PartitionSpec", "ShardedTensor", "shard_map", "all_gather",
           "psum", "psum_scatter", "psum_masked", "reshard", "matvec",
           "gather_blocks",
           "matvec_scatter", "matvec_iterated_reshard",
           "fabric_gemv_batched", "local_matvec", "local_matmat",
           "collectives", "collective_bytes", "local_products",
           "reset_counts"]

collectives: Counter = Counter()          # kind -> calls
collective_bytes: Counter = Counter()     # kind -> bytes put in
local_products: Counter = Counter()       # (storage, B) -> K2 calls

_STORAGE = {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.float16: "f16", torch.int8: "int8"}


def reset_counts() -> None:
    collectives.clear()
    collective_bytes.clear()
    local_products.clear()


class PartitionSpec(tuple):
    """Per tensor dimension: a mesh axis name, a tuple of names (the
    flattened axes, row-major), or ``None`` (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _names(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShardedTensor:
    """A global tensor of ``shape`` laid out over ``mesh`` by ``spec``:
    ``shards[p]`` is the block of mesh position ``p``, a tensor on that
    position's device.  :meth:`full` assembles the global tensor."""

    def __init__(self, mesh: Mesh, spec, shape, shards):
        spec = tuple(spec)
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.spec = P(*(spec + (None,) * (len(self.shape) - len(spec))))
        self.shards = list(shards)
        if len(self.shards) != mesh.size:
            raise ValueError(f"{len(self.shards)} shards on a mesh of "
                             f"{mesh.size}")

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def ranges(self, pos: int) -> tuple[tuple[int, int], ...]:
        """The global index range of position ``pos``'s block, per dim."""
        return _ranges(self.mesh, self.spec, self.shape, pos)

    @classmethod
    def from_global(cls, x: torch.Tensor, mesh: Mesh,
                    spec) -> "ShardedTensor":
        """Cut ``x`` into the blocks of ``spec`` and place each on its
        position's device (a placement, not a collective)."""
        spec = P(*spec)
        placed: dict = {}
        shards = []
        for p, dev in enumerate(mesh.device_list):
            r = _ranges(mesh, spec, x.shape, p)
            key = (dev, r)
            if key not in placed:
                block = x[tuple(slice(a, b) for a, b in r)]
                placed[key] = block.to(dev).contiguous()
            shards.append(placed[key])
        return cls(mesh, spec, x.shape, shards)

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: position 0's)."""
        device = self.device if device is None else torch.device(device)
        blocks = {}
        for p, t in enumerate(self.shards):
            blocks.setdefault(self.ranges(p), t)
        if len(blocks) == 1:
            return next(iter(blocks.values())).to(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for r, t in blocks.items():
            out[tuple(slice(a, b) for a, b in r)] = t.to(device)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, {self.mesh!r})")


def _ranges(mesh: Mesh, spec, shape, pos: int):
    coords = mesh.coords(pos)
    out = []
    for dim, size in enumerate(shape):
        names = _names(spec[dim]) if dim < len(spec) else ()
        idx, count = 0, 1
        for a in names:
            idx = idx * mesh.shape[a] + coords[a]
            count *= mesh.shape[a]
        if size % count:
            raise ValueError(f"dim {dim} of size {size} does not split "
                             f"over {count} shards ({names})")
        step = size // count
        out.append((idx * step, (idx + 1) * step))
    return tuple(out)


def _shards(x) -> list:
    return x.shards if isinstance(x, ShardedTensor) else x


def shard_map(fn, mesh: Mesh, *args) -> list:
    """``fn`` on every mesh position: an argument that is a
    :class:`ShardedTensor` or a list gives each position its own shard,
    anything else is passed as is.  Positions on one device whose shards
    are the same tensors share one result."""
    per_pos = [i for i, a in enumerate(args)
               if isinstance(a, (ShardedTensor, list))]
    cols = [_shards(args[i]) for i in per_pos]
    out, done = [], {}
    for p, dev in enumerate(mesh.device_list):
        key = (dev, tuple(id(c[p]) for c in cols))
        if key not in done:
            call = list(args)
            for i, c in zip(per_pos, cols):
                call[i] = c[p]
            done[key] = fn(*call)
        out.append(done[key])
    return out


@functools.lru_cache(maxsize=None)
def _groups(mesh: Mesh, axes: tuple[str, ...]) -> tuple[tuple[int, ...], ...]:
    """For every position, the positions of its group along ``axes``
    (the other coordinates fixed), in mesh order."""
    sizes = tuple(mesh.shape.values())
    groups = []
    for p in range(mesh.size):
        base = mesh.coords(p)
        members = []
        for combo in itertools.product(*(range(mesh.shape[a])
                                         for a in axes)):
            c = dict(base, **dict(zip(axes, combo)))
            members.append(int(np.ravel_multi_index(
                tuple(c[a] for a in mesh.axis_names), sizes)))
        groups.append(tuple(members))
    return tuple(groups)


def _group_op(xs, mesh: Mesh, axes, combine, kind: str, keep=None) -> list:
    axes = _names(axes)
    xs = _shards(xs)
    out, done = [], {}
    for p, g in enumerate(_groups(mesh, axes)):
        dev = mesh.device_list[p]
        members = [q for q in g if keep is None or keep[q]]
        key = (dev, tuple(id(xs[q]) for q in members))
        if key not in done:
            done[key] = (combine([xs[q].to(dev) for q in members])
                         if members else torch.zeros_like(xs[p]))
        out.append(done[key])
    collectives[kind] += 1
    collective_bytes[kind] += sum(_nbytes(x) for q, x in enumerate(xs)
                                  if keep is None or keep[q])
    return out


def _sum(parts):
    acc = parts[0]
    for t in parts[1:]:
        acc = acc + t
    return acc


def psum(xs, mesh: Mesh, axes) -> list:
    """The sum over each group along ``axes``, in mesh order, on every
    position of the group."""
    return _group_op(xs, mesh, axes, _sum, "psum")


def psum_masked(xs, mesh: Mesh, axes, keep) -> list:
    """:func:`psum` in which only the positions with ``keep[p]`` add their
    shard (the others add zeros, which are skipped)."""
    return _group_op(xs, mesh, axes, _sum, "psum_masked", keep=keep)


def all_gather(xs, mesh: Mesh, axes, dim: int = 0) -> list:
    """Each group's shards concatenated along ``dim`` in mesh order (the
    tiled all-gather), on every position."""
    return _group_op(xs, mesh, axes, lambda parts: torch.cat(parts, dim),
                     "all_gather")


def gather_blocks(groups) -> int:
    """The all-gather of blocks of unequal size, in place.  ``groups`` is a
    list of ``(outs, spans)`` over the same positions: position ``q`` has
    written its block at ``outs[q][a:b]``, ``(a, b) = spans[q]``, and each
    block is copied there into every other position's ``outs[p]``.
    Returns the bytes copied; each group counts as one ``all_gather``.

    Between two cards the copies of a pair ``q -> p`` (every group's block)
    run on a side stream of each card of the pair, after one event on each
    card's current stream, so the twelve pairs of four cards copy at once.
    Each card's current stream then waits on the side streams that
    received its copies; the blocks it sent are kept from reuse until
    their copies are done (``record_stream``), so its next step does not
    wait for what it sends.  Positions of one device copy on its current
    stream."""
    outs0 = groups[0][0]
    devs = [o.device for o in outs0]
    cards = devs[0].type == "cuda" and len(set(devs)) > 1
    if cards:
        main = {d: torch.cuda.current_stream(d) for d in set(devs)}
        ready = {d: s.record_event() for d, s in main.items()}
        used = set()
    moved = 0
    for q, src in enumerate(devs):
        for p, dst in enumerate(devs):
            if p == q:
                continue
            if not cards or src == dst:
                moved += _copy_blocks(groups, q, p)
                continue
            send, recv = _pair_streams(src, dst)
            send.wait_event(ready[src])
            recv.wait_event(ready[dst])
            # copy_ between cards runs on the source's current stream and
            # fences it with the destination's: here the pair's own two
            with torch.cuda.stream(send), torch.cuda.stream(recv):
                moved += _copy_blocks(groups, q, p)
            for outs, _ in groups:
                outs[q].record_stream(send)
            used.add(recv)
    if cards:
        for s in used:
            main[s.device].wait_stream(s)
    for _ in groups:
        collectives["all_gather"] += 1
    collective_bytes["all_gather"] += moved
    return moved


def _copy_blocks(groups, q: int, p: int) -> int:
    moved = 0
    for outs, spans in groups:
        a, b = spans[q]
        outs[p][a:b].copy_(outs[q][a:b])
        moved += _nbytes(outs[q][a:b])
    return moved


_side_streams: dict = {}


def _pair_streams(src: torch.device, dst: torch.device) -> tuple:
    """The side streams of the copies from card ``src`` to card ``dst``:
    one on each card, made at first use."""
    key = (src, dst)
    if key not in _side_streams:
        _side_streams[key] = (torch.cuda.Stream(src), torch.cuda.Stream(dst))
    return _side_streams[key]


def psum_scatter(xs, mesh: Mesh, axes, dim: int = 0) -> list:
    """The group sum along ``axes``, split along ``dim`` into one block per
    group member; each position keeps its own block (tiled)."""
    axes = _names(axes)
    sums = _group_op(xs, mesh, axes, _sum, "psum_scatter")
    out = []
    for p, s in enumerate(sums):
        c = mesh.coords(p)
        idx, count = 0, 1
        for a in axes:
            idx = idx * mesh.shape[a] + c[a]
            count *= mesh.shape[a]
        block = s.shape[dim] // count
        out.append(s.narrow(dim, idx * block, block).contiguous())
    return out


def reshard(x: ShardedTensor, spec) -> ShardedTensor:
    """``x`` in another layout.  Blocks a position already holds are cut
    locally; if any position needs data it does not hold, the global
    tensor is assembled on its device and cut there (one ``reshard``,
    the all-to-all)."""
    spec = P(*(tuple(spec) + (None,) * (len(x.shape) - len(spec))))
    if spec == x.spec:
        return x
    out, done, moved = [], {}, 0
    fulls: dict = {}
    for p, dev in enumerate(x.mesh.device_list):
        dst = _ranges(x.mesh, spec, x.shape, p)
        src = x.ranges(p)
        local = all(s0 <= d0 and d1 <= s1
                    for (s0, s1), (d0, d1) in zip(src, dst))
        key = (dev, dst, id(x.shards[p]) if local else None)
        if key not in done:
            if local:
                base, sl = x.shards[p], tuple(
                    slice(d0 - s0, d1 - s0)
                    for (s0, _), (d0, d1) in zip(src, dst))
            else:
                if dev not in fulls:
                    fulls[dev] = x.full(dev)
                base, sl = fulls[dev], tuple(slice(d0, d1) for d0, d1 in dst)
            done[key] = base[sl].contiguous()
            if not local:
                moved += _nbytes(done[key])
        out.append(done[key])
    if moved:
        collectives["reshard"] += 1
        collective_bytes["reshard"] += moved
    return ShardedTensor(x.mesh, spec, x.shape, out)


def _as(x, mesh: Mesh, spec) -> ShardedTensor:
    if isinstance(x, ShardedTensor):
        return reshard(x, spec)
    return ShardedTensor.from_global(torch.as_tensor(x), mesh, spec)


def local_matmat(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """One shard-local product ``Y = X @ W.T`` (B, N) through K2."""
    local_products[_STORAGE.get(W.dtype, str(W.dtype)), X.shape[0]] += 1
    return streaming_matvec(W, X)


def local_matvec(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One shard-local product ``y = W @ x`` through K2 at B = 1."""
    return local_matmat(W, upcast_f32(x)[None, :])[0]


def matvec(A, x, mesh: Mesh, row_axis: str = "data",
           col_axis: str = "model") -> ShardedTensor:
    """y = A @ x with the fabric schedule.  A: (N, M) sharded over
    (row_axis, col_axis); x: (M,) sharded over col_axis (vertical-bus
    layout); returns y: (N,) sharded over row_axis (adder-column layout).
    Plain tensors are placed first; other layouts are resharded."""
    A = _as(A, mesh, P(row_axis, col_axis))
    x = _as(x, mesh, P(col_axis))
    partial = shard_map(local_matvec, mesh, A, x)      # site multiplies
    y = psum(partial, mesh, col_axis)                   # horizontal bus
    return ShardedTensor(mesh, P(row_axis), (A.shape[0],), y)


def matvec_scatter(A, x, mesh: Mesh, row_axis: str = "data",
                   col_axis: str = "model") -> ShardedTensor:
    """Bandwidth-optimal variant: :func:`psum_scatter` leaves y jointly
    sharded over (row_axis, col_axis) — 1/C of the horizontal-bus traffic
    of :func:`matvec`, at the cost of a blocked y layout."""
    A = _as(A, mesh, P(row_axis, col_axis))
    x = _as(x, mesh, P(col_axis))
    partial = shard_map(local_matvec, mesh, A, x)
    y = psum_scatter(partial, mesh, col_axis, dim=0)
    return ShardedTensor(mesh, P((row_axis, col_axis)), (A.shape[0],), y)


def matvec_iterated_reshard(y_rowrep, mesh: Mesh, row_axis: str = "data",
                            col_axis: str = "model") -> ShardedTensor:
    """Mesh-transpose: y sharded ``P(row_axis)`` (adder-column layout) into
    ``P(col_axis)`` (vertical-bus layout) for the next :func:`matvec`.

    On a square mesh, global column-shard ``c`` of the vector *is*
    row-block ``r = c``, so the exchange is a within-column broadcast from
    the diagonal position — a masked :func:`psum` along ``row_axis`` (the
    fabric re-injecting the adder column onto the vertical bus).  Any
    other mesh takes a global :func:`reshard`."""
    y = _as(y_rowrep, mesh, P(row_axis))
    if mesh.shape[row_axis] != mesh.shape[col_axis]:
        return reshard(y, P(col_axis))
    keep = [c[row_axis] == c[col_axis]
            for c in map(mesh.coords, range(mesh.size))]
    out = psum_masked(y.shards, mesh, row_axis, keep)
    return ShardedTensor(mesh, P(col_axis), y.shape, out)


def fabric_gemv_batched(W, X, mesh: Mesh, row_axis: str = "model",
                        col_axis: str | None = None) -> ShardedTensor:
    """Batched GEMV ``Y = X @ W^T`` with W (out, in) stationary, sharded
    over ``row_axis`` on its output dim, and X (batch, in) replicated: a
    local GEMV per position, then an all-gather of the output shards (the
    adder column is distributed).  Returns Y replicated."""
    W = _as(W, mesh, P(row_axis, None))
    X = _as(X, mesh, P(None, None))
    y = shard_map(lambda w, x: local_matmat(w, upcast_f32(x)), mesh, W, X)
    out = all_gather(y, mesh, row_axis, dim=1)
    return ShardedTensor(mesh, P(None, None), (X.shape[0], W.shape[0]), out)
