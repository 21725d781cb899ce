"""Functional simulator of the messaging-based programmable fabric.

The fabric is an R x C grid of "sites" (Fig. 1A).  Each site owns

* a stored float value (its "FPU register"),
* ``next_opcode`` / ``next_dest`` registers (programmed by ``Prog`` messages),
* four ports: messages arrive from *left* and *top*, leave to *right* and
  *down*.  Messages travel only right/down and wrap circularly (the paper's
  human-chain analogy), so any site can reach any other.

Routing (Fig. 1A, Fig. 5): a message whose destination address equals the
site's own address is consumed/executed; otherwise it is forwarded **down**
if the destination row differs, else **right**.

Two execution modes mirror the paper:

* **hop mode** (:func:`step`, :func:`run`) — cycle-by-cycle synchronous
  message passing, used to reproduce Fig. 2 and the Fig. 5 testbench
  bit-exactly.  Every cycle builds new tensors and never writes into the
  state it was given, so a trace of the wires holds every cycle, and the
  conflict count stays a device scalar (no host sync per cycle).
* **bus mode** (:func:`load_values`, :func:`vbus_mul`,
  :func:`hbus_reduce_rows`) — the single-step vertical-bus broadcast and
  horizontal-bus reduction used by the Fig. 3 matrix-vector schedule.  These
  broadcast over leading batch dimensions (``values`` of shape
  ``(..., R, C)``), so many fabrics take one bus step together.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import isa
from repro_torch.core.isa import Message
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class Fabric:
    """Full architectural state of an R x C fabric."""

    values: torch.Tensor       # (R, C) float32 — stored FPU values
    next_opcode: torch.Tensor  # (R, C) int32
    next_dest: torch.Tensor    # (R, C) int32
    right: Message             # (R, C) message on each right-going output wire
    down: Message              # (R, C) message on each down-going output wire
    conflicts: torch.Tensor    # () int32 — port-contention events (should be 0
                               # for every schedule the paper runs; counted,
                               # not arbitrated, and the tests assert 0)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.values.shape)

    @property
    def device(self) -> torch.device:
        return self.values.device

    @staticmethod
    def create(rows: int, cols: int,
               device: str | torch.device | None = None) -> "Fabric":
        # The adder column is exempt from the site budget: the paper counts
        # "(N x M) + N" sites separately, and its Fig.-4C tiling model uses
        # full 64x64 = 4096 matrix tiles (64x64 data sites + 64 adders is
        # 4160, one column over the 12-bit space).
        if rows * (cols - 1) > isa.MAX_SITES:
            raise ValueError(
                f"{rows}x{cols} exceeds the {isa.ADDR_BITS}-bit address space "
                f"({isa.MAX_SITES} sites + adder column)")
        dev = resolve_device(device)
        zi = torch.zeros((rows, cols), dtype=torch.int32, device=dev)
        return Fabric(values=torch.zeros((rows, cols), dtype=torch.float32,
                                         device=dev),
                      next_opcode=zi, next_dest=zi,
                      right=Message.empty((rows, cols), device=dev),
                      down=Message.empty((rows, cols), device=dev),
                      conflicts=torch.zeros((), dtype=torch.int32,
                                            device=dev))


def addresses(rows: int, cols: int,
              device: str | torch.device | None = None) -> torch.Tensor:
    """Row-major linear site addresses, (R, C) int32."""
    dev = resolve_device(device)
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=dev)
    return ar(rows)[:, None] * cols + ar(cols)[None, :]


def _route_is_down(dest: torch.Tensor, cols: int,
                   my_row: torch.Tensor) -> torch.Tensor:
    """True -> forward down; False -> forward right (for non-local messages)."""
    return torch.div(dest, cols, rounding_mode="floor") != my_row


def _select_msg(pred: torch.Tensor, a: Message, b: Message) -> Message:
    return Message(*(torch.where(pred, getattr(a, f.name), getattr(b, f.name))
                     for f in dataclasses.fields(Message)))


def _mask_msg(keep: torch.Tensor, m: Message) -> Message:
    """NOP-out message slots where ``keep`` is False."""
    return dataclasses.replace(m, opcode=torch.where(keep, m.opcode, isa.NOP))


def _one_of(opcode: torch.Tensor, ops) -> torch.Tensor:
    """``jnp.isin(opcode, ops)`` for a handful of constants."""
    hit = opcode == ops[0]
    for op in ops[1:]:
        hit = hit | (opcode == op)
    return hit


def _edge(inject: Message, rows: int, cols: int, left: bool) -> Message:
    """Edge injections as full-grid messages: column 0 (``left``) or row 0
    carries ``inject``, every other slot is an empty (zero) message."""
    def place(x):
        grid = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
        if left:
            grid[:, 0] = x
        else:
            grid[0, :] = x
        return grid
    return inject.map(place)


def step(state: Fabric, inject_left: Message, inject_top: Message) -> Fabric:
    """One synchronous fabric cycle.

    ``inject_left``: (R,) messages presented at the left ports of column 0
    (the user/testbench side, Fig. 5's ``LeftMessage``).
    ``inject_top``: (C,) messages presented at the top ports of row 0.

    Returns the next state; the new ``right``/``down`` wire fields are what an
    observer (e.g. Fig. 5's ``RightMessage`` / ``DownMessage`` probes on the
    monitored site) sees after this cycle.
    """
    rows, cols = state.shape
    addr = addresses(rows, cols, state.device)
    my_row = torch.div(addr, cols, rounding_mode="floor")

    # ---- 1. incoming messages -------------------------------------------- #
    # Left port of column c receives the right-wire of column c-1 (torus wrap
    # at column 0); an externally injected message takes priority at the edge.
    wrap_l = state.right.map(lambda x: torch.roll(x, 1, dims=1))
    inj_l = _edge(inject_left, rows, cols, left=True)
    from_left = _select_msg(inj_l.is_live(), inj_l, wrap_l)

    wrap_t = state.down.map(lambda x: torch.roll(x, 1, dims=0))
    inj_t = _edge(inject_top, rows, cols, left=False)
    from_top = _select_msg(inj_t.is_live(), inj_t, wrap_t)

    # ---- 2. classify each incoming message ------------------------------- #
    def classify(m: Message):
        live = m.is_live()
        local = live & (m.dest == addr)
        fwd = live & ~local
        goes_down = fwd & _route_is_down(m.dest, cols, my_row)
        goes_right = fwd & ~goes_down
        return local, goes_down, goes_right

    l_local, l_down, l_right = classify(from_left)
    t_local, t_down, t_right = classify(from_top)

    # ---- 3. execute local messages --------------------------------------- #
    # Two ports can deliver in the same cycle; apply top first then left
    # (deterministic order; the paper's schedules never land two messages on
    # one site in one cycle except the adder column, where order is
    # commutative for A_ADD).
    def apply_local(values, next_op, next_dst, emitted, m, is_local):
        term = is_local & _one_of(m.opcode, isa.TERMINAL_OPS)
        strm = is_local & _one_of(m.opcode, isa.STREAMING_OPS)
        new_vals = isa.terminal_result(m.opcode, values, m.value)
        values = torch.where(term, new_vals, values)
        is_prog = is_local & (m.opcode == isa.PROG)
        next_op = torch.where(is_prog, m.next_opcode, next_op)
        next_dst = torch.where(is_prog, m.next_dest, next_dst)
        out_val = isa.streaming_result(m.opcode, values, m.value)
        new_msg = Message(opcode=torch.where(strm, next_op, isa.NOP),
                          dest=next_dst, value=out_val,
                          next_opcode=torch.zeros_like(next_op),
                          next_dest=torch.zeros_like(next_dst))
        # A streaming emission overwrites any pending emission slot (the
        # collision is counted below as both_strm).
        emitted = _select_msg(strm, new_msg, emitted)
        return values, next_op, next_dst, emitted, strm

    emitted = Message.empty((rows, cols), device=state.device)
    values, next_op, next_dst, emitted, t_strm = apply_local(
        state.values, state.next_opcode, state.next_dest, emitted, from_top,
        t_local)
    values, next_op, next_dst, emitted, l_strm = apply_local(
        values, next_op, next_dst, emitted, from_left, l_local)

    e_live = emitted.is_live()
    e_down = e_live & _route_is_down(emitted.dest, cols, my_row)
    e_right = e_live & ~e_down

    # ---- 4. drive output wires (priority: emitted > top > left) ----------- #
    def drive(l_go, t_go, e_go):
        out = Message.empty((rows, cols), device=state.device)
        out = _select_msg(l_go, _mask_msg(l_go, from_left), out)
        out = _select_msg(t_go, _mask_msg(t_go, from_top), out)
        return _select_msg(e_go, _mask_msg(e_go, emitted), out)

    down_out = drive(l_down, t_down, e_down)
    right_out = drive(l_right, t_right, e_right)

    i32 = lambda b: b.to(torch.int32)
    n_down = i32(l_down) + i32(t_down) + i32(e_down)
    n_right = i32(l_right) + i32(t_right) + i32(e_right)
    conflicts = (state.conflicts
                 + torch.sum(torch.clamp(n_down - 1, min=0))
                 + torch.sum(torch.clamp(n_right - 1, min=0))
                 + torch.sum(i32(t_strm & l_strm))).to(torch.int32)

    return Fabric(values=values, next_opcode=next_op, next_dest=next_dst,
                  right=right_out, down=down_out, conflicts=conflicts)


def run(state: Fabric, left_seq: Message, top_seq: Message,
        extra_cycles: int = 0):
    """Drive the fabric with per-cycle injection schedules.

    ``left_seq``: (T, R) messages for the left edge, ``top_seq``: (T, C) for
    the top edge.  Runs ``T + extra_cycles`` cycles (idle injection for the
    drain tail).  Returns (final_state, (right_trace, down_trace)), the
    ``right``/``down`` wire states after every cycle stacked as (T', R, C)
    — the Fig. 5 waveform.
    """
    T = left_seq.shape[0]
    rows, cols = state.shape
    idle_l = Message.empty((rows,), device=state.device)
    idle_t = Message.empty((cols,), device=state.device)
    rights, downs = [], []
    for t in range(T + extra_cycles):
        if t < T:
            inj_l = left_seq.map(lambda x: x[t])
            inj_t = top_seq.map(lambda x: x[t])
        else:
            inj_l, inj_t = idle_l, idle_t
        state = step(state, inj_l, inj_t)
        rights.append(state.right)
        downs.append(state.down)
    return state, (isa.stack(rights), isa.stack(downs))


# --------------------------------------------------------------------------- #
# Bus mode — the Fig. 3 single-step collectives                               #
# --------------------------------------------------------------------------- #
def load_values(state: Fabric, block: torch.Tensor, row0: int = 0,
                col0: int = 0) -> Fabric:
    """Direct value load, the fast path equivalent of N hop-load
    steps.  ``schedule.py`` accounts the paper's step cost separately.
    ``block`` is (..., r, c): leading dimensions give one fabric each."""
    r, c = block.shape[-2:]
    batch = tuple(block.shape[:-2])
    values = state.values.expand(batch + state.values.shape[-2:]).clone()
    values[..., row0:row0 + r, col0:col0 + c] = block
    return dataclasses.replace(state, values=values)


def vbus_mul(state: Fabric, vec: torch.Tensor, cols_slice=None) -> Fabric:
    """Vertical-bus broadcast multiply: every site in column c multiplies its
    stored value by ``vec[..., c]`` (1 time step in the paper's accounting)."""
    v = torch.as_tensor(vec, dtype=torch.float32, device=state.device)
    if cols_slice is not None:
        mask = torch.zeros(state.shape[-1], dtype=torch.bool,
                           device=state.device)
        mask[cols_slice] = True
        v = torch.where(mask, v, 1.0)
    return dataclasses.replace(state, values=state.values * v[..., None, :])


def hbus_reduce_rows(state: Fabric, ncols: int | None = None
                     ) -> torch.Tensor:
    """Horizontal-bus reduction: each row streams its products to the adder
    site; returns the per-row sums (1 time step in the paper's accounting).
    The adder starts at 0 and takes the products in column order, as the
    streamed ``A_ADD`` messages arrive (the order XLA's row sum takes on
    the CPU for up to 16 columns)."""
    vals = state.values if ncols is None else state.values[..., :ncols]
    acc = torch.zeros(vals.shape[:-1], dtype=vals.dtype, device=vals.device)
    for c in range(vals.shape[-1]):
        acc = acc + vals[..., c]
    return acc
