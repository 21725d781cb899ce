"""The plain reference's power iteration with H's rows split into blocks
over several devices, for graphs whose H one card cannot hold.

``Operator`` is :class:`perfbench.reference.pagerank.Operator`'s CSR
product cut by rows: ``H[i, j] = 1 / outdeg(j)`` for an edge j -> i, the
rows in contiguous blocks of the caller's ids that carry about equal
numbers of entries, one block per device (a device may come more than
once).  The edges may lie on the host: they are read in chunks of
:data:`CHUNK` on the first device, which counts the degrees and sends each
block its edges.  A product sends ``x / outdeg`` to every block's device,
sums each row there (``index_add_``) and brings the blocks back to the
first device, where :func:`perfbench.reference.pagerank.pagerank` runs
the same iteration as for one device: float64, or for the control
TF32-rounded operands with float32 sums, each product ``tf32(x[j]) *
tf32(1 / outdeg(j))`` as :class:`~perfbench.reference.pagerank.Operator`
forms it.  Plain torch; nothing of the program.
"""
from __future__ import annotations

import torch

from perfbench.reference.pagerank import DTYPES, pagerank, tf32

__all__ = ["Operator", "pagerank", "global_ranks"]

CHUNK = 1 << 27          # edges read at once


def _blocks(indeg: torch.Tensor, parts: int) -> list[int]:
    """Bounds ``[0, ..., n]`` of ``parts`` row ranges of about equal
    entries (each at least one row where n allows)."""
    n = indeg.numel()
    cum = torch.cumsum(indeg, 0)
    total = int(cum[-1]) if n else 0
    bounds = [0]
    for b in range(1, parts):
        r = int(torch.searchsorted(cum, total * b // parts)) + 1
        bounds.append(min(max(r, bounds[-1] + 1), n))
    bounds.append(n)
    return [min(x, n) for x in bounds]


class Operator:
    """``y = H @ x`` for a vector (n,), H's rows in blocks over
    ``devices``, in float64 or, for the control, on TF32-rounded operands
    with float32 sums.  ``dang`` and the vectors live on the first
    device."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int,
                 devices, *, precision: str = "f64"):
        self.devices = [torch.device(d) for d in devices]
        first = self.devices[0]
        self.n = int(n)
        self.precision = precision
        dtype = DTYPES[precision]
        outdeg = torch.zeros(self.n, dtype=torch.int64, device=first)
        indeg = torch.zeros(self.n, dtype=torch.int64, device=first)
        for a in range(0, src.numel(), CHUNK):
            outdeg += torch.bincount(src[a:a + CHUNK].to(first).long(),
                                     minlength=self.n)
            indeg += torch.bincount(dst[a:a + CHUNK].to(first).long(),
                                    minlength=self.n)
        self.dang = (outdeg == 0).to(dtype)
        w = torch.where(outdeg > 0, 1.0 / outdeg.to(torch.float64), 0.0)
        self.w = self._round(w.to(dtype))
        self.bounds = _blocks(indeg, len(self.devices))
        del outdeg, indeg
        rows = [[] for _ in self.devices]
        cols = [[] for _ in self.devices]
        for a in range(0, src.numel(), CHUNK):
            s = src[a:a + CHUNK].to(first).long()
            d = dst[a:a + CHUNK].to(first).long()
            for q, dev in enumerate(self.devices):
                lo, hi = self.bounds[q], self.bounds[q + 1]
                keep = (d >= lo) & (d < hi)
                rows[q].append((d[keep] - lo).to(dev))
                cols[q].append(s[keep].to(dev))
        self.rows = [torch.cat(r) for r in rows]
        self.cols = [torch.cat(c) for c in cols]

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        return tf32(t) if self.precision == "tf32" else t

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        z = self._round(x) * self.w
        out = torch.empty_like(x)
        for q, dev in enumerate(self.devices):
            lo, hi = self.bounds[q], self.bounds[q + 1]
            zq = z.to(dev)
            y = torch.zeros(hi - lo, dtype=x.dtype, device=dev).index_add_(
                0, self.rows[q], zq[self.cols[q]])
            out[lo:hi] = y.to(x.device)
        return out


def global_ranks(src: torch.Tensor, dst: torch.Tensor, n: int, d: float,
                 n_iters: int, devices,
                 precision: str = "f64") -> torch.Tensor:
    """Global PageRank, ``n_iters`` steps from the uniform vector, on the
    first device."""
    return pagerank(Operator(src, dst, n, devices, precision=precision), d,
                    n_iters)
