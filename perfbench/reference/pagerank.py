"""Power iteration over a column-stochastic transition matrix.

``H[i, j] = 1 / outdeg(j)`` for an edge j -> i; a dangling vertex (no
out-edges) leaks its rank uniformly (global PageRank) or to the teleport
distribution (personalized PageRank).  ``Operator`` holds H dense or in
CSR (rows in order, one ``index_add_`` per product).
"""
from __future__ import annotations

import numpy as np
import torch

DTYPES = {"f64": torch.float64, "tf32": torch.float32}


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to TF32 (10 explicit mantissa bits), to
    nearest, ties to even: what a tensor core reads of a float32
    operand."""
    i = t.contiguous().view(torch.int32)
    bias = 0xFFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


class Operator:
    """``y = H @ x`` for a vector (n,) or a block (n, Q), in float64 or,
    for the control, on TF32-rounded operands with float32 sums."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int, *,
                 layout: str = "dense", precision: str = "f64"):
        dev = src.device
        self.n = int(n)
        self.precision = precision
        self.layout = layout
        dtype = DTYPES[precision]
        src, dst = src.to(torch.int64), dst.to(torch.int64)
        outdeg = torch.bincount(src, minlength=self.n)
        self.dang = (outdeg == 0).to(dtype)
        w = 1.0 / outdeg[src].to(torch.float64)
        w = self._round(w.to(dtype))
        if layout == "dense":
            self.H = torch.zeros((self.n, self.n), dtype=dtype, device=dev)
            self.H[dst, src] = w
        elif layout == "csr":
            order = torch.argsort(dst * self.n + src)
            counts = torch.bincount(dst, minlength=self.n)
            self.indptr = torch.cat([counts.new_zeros(1),
                                     torch.cumsum(counts, 0)])
            self.rows = torch.repeat_interleave(
                torch.arange(self.n, device=dev), counts)
            self.cols = src[order]
            self.vals = w[order]
        else:
            raise ValueError(f"unknown layout {layout!r}")

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        return tf32(t) if self.precision == "tf32" else t

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        x = self._round(x)
        if self.layout == "dense":
            return self.H @ x
        prod = (self.vals * x[self.cols] if x.dim() == 1
                else self.vals[:, None] * x[self.cols])
        return torch.zeros((self.n, *x.shape[1:]), dtype=x.dtype,
                           device=x.device).index_add_(0, self.rows, prod)


def pagerank(op: Operator, d: float, n_iters: int) -> torch.Tensor:
    """Global PageRank: ``n_iters`` steps from the uniform vector."""
    n = op.n
    x = torch.full((n,), 1.0 / n, dtype=op.dang.dtype, device=op.dang.device)
    for _ in range(int(n_iters)):
        x = d * (op.matvec(x) + torch.dot(op.dang, x) / n) + (1.0 - d) / n
    return x


def seed_matrix(n: int, seed_sets, dtype, device) -> torch.Tensor:
    """(n, Q) teleport distributions, uniform over each set's unique
    seeds."""
    V = np.zeros((n, len(seed_sets)), np.float64)
    for q, seeds in enumerate(seed_sets):
        s = np.unique(np.asarray(seeds, np.int64))
        V[s, q] = 1.0 / s.size
    return torch.from_numpy(V).to(device=device, dtype=dtype)


def ppr(op: Operator, seed_sets, d: float, n_iters: int) -> torch.Tensor:
    """Personalized PageRank of each seed set, (n, Q): ``n_iters`` steps
    from the teleport distribution, dangling rank leaking to it."""
    V = seed_matrix(op.n, seed_sets, op.dang.dtype, op.dang.device)
    X = V
    for _ in range(int(n_iters)):
        X = d * (op.matvec(X) + V * (op.dang @ X)[None, :]) + (1.0 - d) * V
    return X
