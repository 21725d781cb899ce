"""Instruction-set architecture of the messaging-based programmable fabric.

Implements the 64-bit message encoding of Fig. 1B and the 10-instruction ISA of
Fig. 1C, bit-exact against the Fig. 5 waveform hex values:

    bits  0-3   opcode
    bits  4-15  destination address (12 bits -> up to 4096 sites)
    bits 16-47  value (IEEE-754 binary32)
    bits 48-51  next opcode
    bits 52-63  next destination

Confirmed codes (decoded from the paper's Fig. 5 message hex): Prog=1, A_ADD=4,
A_ADDS=7.  The remaining assignments are the JAX package's documented
inference (``repro.core.isa``).

Messages are a struct-of-arrays :class:`Message` of int32 / float32 tensors,
one message per port per site.  :func:`pack` / :func:`unpack` convert to the
wire format as a pair of 32-bit words held in int64 tensors (torch has no
shifts on ``uint32``); the value's bits are taken and restored through an
int32 view, so every payload, NaNs included, survives a round trip.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

# --------------------------------------------------------------------------- #
# Opcodes (Fig. 1C).  Prog=1 / A_ADD=4 / A_ADDS=7 are verified against Fig. 5. #
# --------------------------------------------------------------------------- #
NOP = 0        # absence of a message (not part of the paper's 10; wire-level idle)
PROG = 1       # program a site: value + next_opcode/next_dest registers
UPDATE = 2     # overwrite the stored value
A_DIV = 3      # stored <- stored / msg
A_ADD = 4      # stored <- stored + msg          (terminal; verified =4)
A_SUB = 5      # stored <- stored - msg
A_MUL = 6      # stored <- stored * msg
A_ADDS = 7     # emit msg + stored               (streaming; verified =7)
A_SUBS = 8     # emit msg - stored
A_MULS = 9     # emit msg * stored
A_DIVS = 10    # emit msg / stored

OPCODE_NAMES = {
    NOP: "NOP", PROG: "Prog", UPDATE: "UPDATE", A_DIV: "A_DIV", A_ADD: "A_ADD",
    A_SUB: "A_SUB", A_MUL: "A_MUL", A_ADDS: "A_ADDS", A_SUBS: "A_SUBS",
    A_MULS: "A_MULS", A_DIVS: "A_DIVS",
}
OPCODES_BY_NAME = {v: k for k, v in OPCODE_NAMES.items()}

#: opcodes that terminate at the destination site (absorb the message)
TERMINAL_OPS = (PROG, UPDATE, A_DIV, A_ADD, A_SUB, A_MUL)
#: opcodes that compute with the stored value and re-emit a message
STREAMING_OPS = (A_ADDS, A_SUBS, A_MULS, A_DIVS)

ADDR_BITS = 12
MAX_SITES = 1 << ADDR_BITS  # 4096 — exactly the paper's evaluated fabric size

_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Message:
    """Struct-of-arrays message bundle. All fields share a leading shape.

    ``opcode == NOP`` marks an empty slot (no message on the wire).
    """

    opcode: torch.Tensor       # int32
    dest: torch.Tensor         # int32 (12-bit address)
    value: torch.Tensor        # float32
    next_opcode: torch.Tensor  # int32
    next_dest: torch.Tensor    # int32

    @staticmethod
    def make(opcode, dest, value, next_opcode=NOP, next_dest=0, *,
             device: str | torch.device | None = None) -> "Message":
        """Fields broadcast to one shape.  The device is ``device`` if
        given, else that of the first tensor argument, else the card.
        Python and numpy scalars are filled in on the device, so making a
        message costs no copy from the host."""
        args = (opcode, dest, value, next_opcode, next_dest)
        if device is None:
            device = next((a.device for a in args
                           if isinstance(a, torch.Tensor)), None)
        dev = resolve_device(device)
        shape = torch.broadcast_shapes(*(
            a.shape if isinstance(a, torch.Tensor) else np.shape(a)
            for a in args))

        def field(x, dtype):
            if isinstance(x, np.generic):
                x = x.item()
            if isinstance(x, (int, float)):
                return torch.full(shape, x, dtype=dtype, device=dev)
            return torch.as_tensor(x, dtype=dtype, device=dev).expand(
                shape).contiguous()

        i32 = torch.int32
        return Message(field(opcode, i32), field(dest, i32),
                       field(value, torch.float32), field(next_opcode, i32),
                       field(next_dest, i32))

    @staticmethod
    def empty(shape=(), *, device: str | torch.device | None = None
              ) -> "Message":
        dev = resolve_device(device)
        z = lambda dtype: torch.zeros(shape, dtype=dtype, device=dev)
        return Message(z(torch.int32), z(torch.int32), z(torch.float32),
                       z(torch.int32), z(torch.int32))

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.opcode.shape)

    def is_live(self) -> torch.Tensor:
        return self.opcode != NOP

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Message":
        """``fn`` applied to every field (``jax.tree.map`` over one
        message)."""
        return Message(*(fn(getattr(self, f.name))
                         for f in dataclasses.fields(self)))


def stack(msgs: Sequence[Message], dim: int = 0) -> Message:
    """Stack messages field by field, as ``jax.tree.map(jnp.stack, *msgs)``."""
    return Message(*(torch.stack([getattr(m, f.name) for m in msgs], dim)
                     for f in dataclasses.fields(Message)))


# --------------------------------------------------------------------------- #
# Wire format                                                                  #
# --------------------------------------------------------------------------- #
def _f32_bits(value: torch.Tensor) -> torch.Tensor:
    """The float32 bits as int64 in [0, 2**32)."""
    return value.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & _MASK32


def _bits_f32(bits: torch.Tensor) -> torch.Tensor:
    """int64 bits in [0, 2**32) back to float32, through an int32 view."""
    signed = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return signed.to(torch.int32).view(torch.float32)


def pack(msg: Message) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack to (lo, hi) 32-bit words held in int64 tensors: lo = bits
    0..31, hi = bits 32..63."""
    i64 = lambda x: x.to(torch.int64)
    op = i64(msg.opcode) & 0xF
    dest = i64(msg.dest) & 0xFFF
    val = _f32_bits(msg.value)
    nop = i64(msg.next_opcode) & 0xF
    ndst = i64(msg.next_dest) & 0xFFF
    lo = op | (dest << 4) | ((val & 0xFFFF) << 16)
    hi = (val >> 16) | (nop << 16) | (ndst << 20)
    return lo, hi


def unpack(lo, hi, *, device: str | torch.device | None = None) -> Message:
    """The inverse of :func:`pack`.  ``lo`` and ``hi`` are the two 32-bit
    words as tensors (their device is kept) or as integers / numpy arrays
    (placed on ``device``, by default the card)."""
    if not isinstance(lo, torch.Tensor):
        dev = resolve_device(device)
        lo = torch.as_tensor(lo, dtype=torch.int64, device=dev)
        hi = torch.as_tensor(hi, dtype=torch.int64, device=dev)
    lo = lo.to(torch.int64) & _MASK32
    hi = hi.to(torch.int64) & _MASK32
    i32 = lambda x: x.to(torch.int32)
    return Message(opcode=i32(lo & 0xF), dest=i32((lo >> 4) & 0xFFF),
                   value=_bits_f32((lo >> 16) | ((hi & 0xFFFF) << 16)),
                   next_opcode=i32((hi >> 16) & 0xF),
                   next_dest=i32((hi >> 20) & 0xFFF))


def pack_word(msg: Message) -> int:
    """Pack a scalar Message into a python int (the 64-bit wire word)."""
    lo, hi = pack(msg)
    return int(lo) | (int(hi) << 32)


def unpack_word(word: int, *, device: str | torch.device | None = None
                ) -> Message:
    return unpack(word & _MASK32, word >> 32, device=device)


def to_hex(msg: Message) -> str:
    """Wire word as the 16-hex-digit string used in the paper's Fig. 5 table."""
    return f"{pack_word(msg):016x}"


def from_hex(s: str, *, device: str | torch.device | None = None) -> Message:
    return unpack_word(int(s, 16), device=device)


def describe(msg: Message) -> str:
    """Human-readable rendering matching the Fig. 5 table columns."""
    return (f"{OPCODE_NAMES.get(int(msg.opcode), '?')} dest={int(msg.dest)} "
            f"value={float(msg.value):g} "
            f"next={OPCODE_NAMES.get(int(msg.next_opcode), '?')} "
            f"next_dest={int(msg.next_dest)}")


# --------------------------------------------------------------------------- #
# ALU semantics shared by the simulator (vectorized over sites)               #
# --------------------------------------------------------------------------- #
def _select(opcode: torch.Tensor, cases, default: torch.Tensor
            ) -> torch.Tensor:
    """``jnp.select`` over ``opcode == op`` conditions: the first match
    wins.  Every branch is computed, as in the JAX package; a division by
    zero in a branch that is not taken is discarded."""
    out = default
    for op, val in reversed(cases):
        out = torch.where(opcode == op, val, out)
    return out


def terminal_result(opcode: torch.Tensor, stored: torch.Tensor,
                    incoming: torch.Tensor) -> torch.Tensor:
    """New stored value after a terminal op lands (vectorized)."""
    return _select(opcode, [
        (PROG, incoming), (UPDATE, incoming), (A_ADD, stored + incoming),
        (A_SUB, stored - incoming), (A_MUL, stored * incoming),
        (A_DIV, stored / incoming)], default=stored)


def streaming_result(opcode: torch.Tensor, stored: torch.Tensor,
                     incoming: torch.Tensor) -> torch.Tensor:
    """Value re-emitted by a streaming (``*S``) op (vectorized)."""
    return _select(opcode, [
        (A_ADDS, incoming + stored), (A_SUBS, incoming - stored),
        (A_MULS, incoming * stored), (A_DIVS, incoming / stored)],
        default=incoming)
