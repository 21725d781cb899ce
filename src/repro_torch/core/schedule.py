"""Fig. 3 / Fig. 4 schedules: matrix-vector multiply and PageRank on the fabric.

Reproduces the paper's four-stage MV schedule with exact step accounting:

  1. *matrix load*  — N steps (rows hop in one per cycle, last row first),
  2. *vector load + multiply* — 1 step (vertical bus),
  3. *addition* — 1 step (horizontal bus into the adder column),
  4. *offload* — 1 step,

total **N + 3** steps for an (N x M) matrix (independent of M), and the
PageRank iteration at **N + 6** steps (Fig. 4B):  MV (N+3) + scalar-d multiply
(1) + teleport add (1) + offload (1).

Two execution backends:

* ``use_messages=True`` — the matrix is actually loaded with ``Prog``
  messages hopping through the grid (faithful hop-mode; small fabrics).
* ``use_messages=False`` — values are placed directly and only the *step
  accounting* follows the paper (fast; any fabric that fits the address
  space).  This mode also takes a stack of matrices (..., N, M) and
  vectors (..., M), one fabric each, in one bus pass; the Fig. 4C tiled
  schedule runs an iteration's tile passes that way.

Both give bit-identical numerics for the compute stages.  Step counts are
python ints.  Everything runs on the device of the matrix.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import fabric as fab
from repro_torch.core import isa
from repro_torch.core.isa import Message
from repro_torch.kernels.common import resolve_device


class ScheduleResult(NamedTuple):
    result: torch.Tensor            # computed output vector
    steps: int                      # paper-accounted time steps
    state: fab.Fabric | None        # final fabric state (for inspection)


def _f32(x) -> torch.Tensor:
    """A float32 tensor on the device of ``x``; anything else than a tensor
    goes to the card."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=resolve_device(None))


def _load_matrix_with_messages(state: fab.Fabric, A: torch.Tensor
                               ) -> fab.Fabric:
    """Load A (N x M) into the top-left N x M sites via hop-mode ``Prog``
    messages entering at the top ports, one matrix row per cycle, **last row
    first** (the paper's order), pipelined down the columns.

    Takes N injection cycles + N drain cycles of wall-clock simulation;
    the paper's accounting charges N steps (the drain overlaps the next
    row's hop — the fabric is a pipeline).
    """
    N, M = A.shape
    rows, cols = state.shape
    if N > rows or M > cols:
        raise ValueError(f"a {N}x{M} matrix does not fit a {rows}x{cols} "
                         "fabric")
    dev = state.device

    # Injection schedule: cycle t carries matrix row (N-1-t) addressed to
    # fabric row (N-1-t); messages enter at the top of columns 0..M-1.
    T = N
    dest_rows = torch.arange(N - 1, -1, -1, dtype=torch.int32, device=dev)
    dests = dest_rows[:, None] * cols + torch.arange(
        M, dtype=torch.int32, device=dev)[None, :]                  # (T, M)
    vals = A[dest_rows.long()]                                      # (T, M)

    pad = lambda x: torch.nn.functional.pad(x, (0, cols - M))
    top_seq = Message.make(
        opcode=pad(torch.full((T, M), isa.PROG, dtype=torch.int32,
                              device=dev)),
        dest=pad(dests), value=pad(vals),
        next_opcode=torch.zeros((T, cols), dtype=torch.int32, device=dev),
        next_dest=torch.zeros((T, cols), dtype=torch.int32, device=dev))
    left_seq = Message.empty((T, rows), device=dev)
    state, _ = fab.run(state, left_seq, top_seq, extra_cycles=N)
    return state


def matvec(A, b, fabric_shape: tuple[int, int] | None = None,
           use_messages: bool = False) -> ScheduleResult:
    """The paper's MV schedule. A: (..., N, M), b: (..., M) -> (..., N),
    N+3 steps.  Leading dimensions (fast mode only) run one fabric each."""
    A = _f32(A)
    b = _f32(b).to(A.device)
    N, M = A.shape[-2:]
    if fabric_shape is None:
        fabric_shape = (N, M + 1)       # + the adder column (paper: +N sites)
    rows, cols = fabric_shape
    state = fab.Fabric.create(rows, cols, A.device)

    # Stage 1 — matrix load: N steps.
    if use_messages:
        if A.dim() != 2:
            raise ValueError("hop mode loads one (N, M) matrix")
        state = _load_matrix_with_messages(state, A)
    else:
        state = fab.load_values(state, A)
    steps = N

    # Stage 2 — vector load + multiply via vertical bus: 1 step.
    vec = torch.ones(b.shape[:-1] + (cols,), dtype=torch.float32,
                     device=A.device)
    vec[..., :M] = b
    state = fab.vbus_mul(state, vec)
    steps += 1

    # Stage 3 — horizontal-bus addition into the adder column: 1 step.
    # (the bus pass left fresh values, so the column is written in place)
    sums = fab.hbus_reduce_rows(state, ncols=M)
    state.values[..., :, -1] = 0.0
    state.values[..., :N, -1] = sums[..., :N]
    steps += 1

    # Stage 4 — offload: 1 step.
    result = state.values[..., :N, -1]
    steps += 1

    return ScheduleResult(result=result, steps=steps, state=state)


def pagerank_iteration(H, pr, d: float = 0.85,
                       use_messages: bool = False) -> ScheduleResult:
    """One PageRank iteration on the fabric (Fig. 4B): N + 6 steps.

    PR_n = d * H @ PR_{n-1} + (1 - d) / N
    """
    N = H.shape[0]
    mv = matvec(H, pr, use_messages=use_messages)        # N + 3
    steps = mv.steps
    # scalar d load + multiply: 1 step (d broadcast on the vertical bus).
    scaled = mv.result * d
    steps += 1
    # teleport-term addition: 1 step.
    out = scaled + (1.0 - d) / N
    steps += 1
    # offload: 1 step.
    steps += 1
    return ScheduleResult(result=out, steps=steps, state=mv.state)


def pagerank_tiled(H, n_iters: int = 100, d: float = 0.85,
                   n_sites: int = 4096) -> ScheduleResult:
    """Fig. 4C: finite-fabric PageRank.  The N x N matrix is processed in
    sqrt(S) x sqrt(S) tiles; each tile pass costs (sqrt(S) + 6) steps, so a
    full iteration costs ceil(N^2/S) * (sqrt(S) + 6) — the model behind the
    paper's 213.6 ms headline, executed here with real numerics.

    An iteration's nt x nt tile passes run as one bus pass over a stack of
    (sqrt(S), sqrt(S) + 1) fabrics; the column-tile partials are then added
    in the order bj = 0, 1, ... that a pass-by-pass execution takes."""
    H = _f32(H)
    N = H.shape[0]
    ts = int(math.isqrt(n_sites))
    Np = (N + ts - 1) // ts * ts
    nt = Np // ts
    Hp = torch.zeros((Np, Np), dtype=torch.float32, device=H.device)
    Hp[:N, :N] = H
    tiles = Hp.view(nt, ts, nt, ts).transpose(1, 2)     # (bi, bj, ts, ts)
    pr = torch.full((N,), 1.0 / N, dtype=torch.float32, device=H.device)
    # Paper accounting (Fig. 4C): ceil(N^2 / S) tiles per iteration at
    # (sqrt(S) + 6) steps each.  (The execution pads to whole tiles;
    # padded passes are an implementation artifact the paper does not
    # charge, so the step count uses the paper's exact formula.)
    steps = n_iters * math.ceil(N * N / n_sites) * (ts + 6)
    for _ in range(n_iters):
        prp = torch.zeros((Np,), dtype=torch.float32, device=H.device)
        prp[:N] = pr
        mv = matvec(tiles, prp.view(nt, ts), fabric_shape=(ts, ts + 1))
        acc = torch.zeros((nt, ts), dtype=torch.float32, device=H.device)
        for bj in range(nt):
            acc = acc + mv.result[:, bj]
        pr = d * acc.view(Np)[:N] + (1.0 - d) / N
    return ScheduleResult(result=pr, steps=steps, state=None)


def pagerank(H, n_iters: int = 100, d: float = 0.85,
             use_messages: bool = False) -> ScheduleResult:
    """n full iterations (Fig. 4B: n * (N + 6) steps)."""
    H = _f32(H)
    N = H.shape[0]
    pr = torch.full((N,), 1.0 / N, dtype=torch.float32, device=H.device)
    total = 0
    state = None
    for _ in range(n_iters):
        res = pagerank_iteration(H, pr, d, use_messages=use_messages)
        pr = res.result
        total += res.steps
        state = res.state
    return ScheduleResult(result=pr, steps=total, state=state)
