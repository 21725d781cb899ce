"""PyTorch port, the fabric simulator: every case of tests/test_isa.py,
tests/test_fabric.py and tests/test_schedule.py run through the JAX package
and the port (``repro_torch.core.isa`` / ``fabric`` / ``schedule``,
``pagerank_on_fabric``) on the same inputs, each held to the original
assertions and the two held to each other: the codec and hop mode (every
cycle's wires and the final state) bit for bit, bus mode at rtol 1e-6, the
Fig. 4C tiled schedule at rtol 1e-5 / atol 1e-7 with equal step counts.
Random hop-mode streams start both simulators from one state, carried
across by ``repro_torch.core.convert``.  The port runs on the CPU here."""
import contextlib
import dataclasses
import importlib.util
import io
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import fabric as jfabric
from repro.core import isa as jisa
from repro.core import schedule as jschedule
from repro.core import timing as jtiming
from repro.graph import generators as jgen
from repro.graph import transition as jtr
from repro.pagerank import pagerank_on_fabric as j_pagerank_on_fabric
from repro_torch.core import fabric, isa, schedule, timing
from repro_torch.core.convert import fabric_from_numpy, message_from_numpy
from repro_torch.graph.generators import protein_network
from repro_torch.graph.transition import build_transition_dense
from repro_torch.pagerank import pagerank_dense_fixed, pagerank_on_fabric

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# The six messages of the paper's Fig. 5 testbench, as tests/test_isa.py
# lists them (TOP-3 / TOP-5 corrected from the paper's 17-digit typos).
FIG5_MESSAGES = [
    ("00f44121999a0051", isa.PROG, 5, 10.1, isa.A_ADD, 15, "LEFT-1"),
    ("00f44111999a0091", isa.PROG, 9, 9.1, isa.A_ADD, 15, "TOP-1"),
    ("00f44101999a0091", isa.PROG, 9, 8.1, isa.A_ADD, 15, "TOP-2"),
    ("00f440e333330091", isa.PROG, 9, 7.1, isa.A_ADD, 15, "TOP-3"),
    ("00d7404000000091", isa.PROG, 9, 3.0, isa.A_ADDS, 13, "TOP-4"),
    ("00f440c333330091", isa.PROG, 9, 6.1, isa.A_ADD, 15, "TOP-5"),
]


# --------------------------------------------------------------------- #
# the two packages behind one interface                                 #
# --------------------------------------------------------------------- #
# one compilation per shape, where the eager lax.scan compiles per call
_jax_run = jax.jit(jfabric.run, static_argnames="extra_cycles")
_jax_matvec = jax.jit(jschedule.matvec,
                      static_argnames=("fabric_shape", "use_messages"))


class JaxSide:
    name = "jax"
    isa = jisa

    @staticmethod
    def make(*a):
        return jisa.Message.make(*a)

    @staticmethod
    def empty(shape):
        return jisa.Message.empty(shape)

    @staticmethod
    def from_hex(hx):
        return jisa.from_hex(hx)

    @staticmethod
    def stack(msgs):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *msgs)

    @staticmethod
    def put(edge, idx, m):
        return jax.tree.map(lambda e, x: e.at[idx].set(jnp.asarray(x)),
                            edge, m)

    @staticmethod
    def create(rows, cols):
        return jfabric.Fabric.create(rows, cols)

    @staticmethod
    def addresses(rows, cols):
        return jfabric.addresses(rows, cols)

    @staticmethod
    def run(state, left, top, extra_cycles=0):
        return _jax_run(state, left, top, extra_cycles=extra_cycles)

    @staticmethod
    def matvec(A, b, **kw):
        return _jax_matvec(jnp.asarray(A), jnp.asarray(b), **kw)


class TorchSide:
    name = "torch"
    isa = isa

    @staticmethod
    def make(*a):
        return isa.Message.make(*a, device=CPU)

    @staticmethod
    def empty(shape):
        return isa.Message.empty(shape, device=CPU)

    @staticmethod
    def from_hex(hx):
        return isa.from_hex(hx, device=CPU)

    @staticmethod
    def stack(msgs):
        return isa.stack(msgs)

    @staticmethod
    def put(edge, idx, m):
        def one(e, x):
            e = e.clone()
            e[idx] = x
            return e
        return isa.Message(*(one(getattr(edge, f.name), getattr(m, f.name))
                             for f in dataclasses.fields(isa.Message)))

    @staticmethod
    def create(rows, cols):
        return fabric.Fabric.create(rows, cols, CPU)

    @staticmethod
    def addresses(rows, cols):
        return fabric.addresses(rows, cols, CPU)

    @staticmethod
    def run(state, left, top, extra_cycles=0):
        return fabric.run(state, left, top, extra_cycles=extra_cycles)

    @staticmethod
    def matvec(A, b, **kw):
        return schedule.matvec(torch.as_tensor(np.asarray(A)),
                               torch.as_tensor(np.asarray(b)), **kw)


SIDES = (JaxSide, TorchSide)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tree(obj):
    """A message or fabric state of either package (or a tuple of them) as
    nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(obj):
        return {f.name: tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(tree(o) for o in obj)
    return _np(obj)


def assert_same_bits(a, b, path="state"):
    """Equal trees, leaf for leaf, bit for bit (float32 compared as its
    int32 bits, so -0.0 and NaN payloads count)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same_bits(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_bits(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (
            path, a.dtype, b.dtype, a.shape, b.shape)
        bits = (lambda v: v.view(np.int32)) if a.dtype == np.float32 else (
            lambda v: v)
        assert np.array_equal(bits(a), bits(b)), path


def both(case, *args):
    """Run ``case`` through each package and hold the two results (numpy
    trees) bit for bit."""
    j, t = (tree(case(side, *args)) for side in SIDES)
    assert_same_bits(t, j)
    return t


# --------------------------------------------------------------------- #
# tests/test_isa.py                                                     #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
@pytest.mark.parametrize("hx,op,dest,val,nop,ndest,label", FIG5_MESSAGES)
def test_fig5_decode(side, hx, op, dest, val, nop, ndest, label):
    m = side.from_hex(hx)
    assert int(m.opcode) == op
    assert int(m.dest) == dest
    assert float(m.value) == pytest.approx(val, rel=1e-6)
    assert int(m.next_opcode) == nop
    assert int(m.next_dest) == ndest
    assert_same_bits(tree(m), tree(jisa.from_hex(hx)))


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
@pytest.mark.parametrize("hx,op,dest,val,nop,ndest,label", FIG5_MESSAGES)
def test_fig5_encode(side, hx, op, dest, val, nop, ndest, label):
    m = side.make(op, dest, val, nop, ndest)
    assert side.isa.to_hex(m) == hx
    assert side.isa.describe(m) == jisa.describe(jisa.from_hex(hx))


def test_opcode_tables():
    assert len(isa.OPCODE_NAMES) == 11  # 10 ISA entries + NOP
    assert set(isa.TERMINAL_OPS) | set(isa.STREAMING_OPS) == (
        set(isa.OPCODE_NAMES) - {isa.NOP})
    assert isa.PROG == 1 and isa.A_ADD == 4 and isa.A_ADDS == 7
    for name in ("OPCODE_NAMES", "OPCODES_BY_NAME", "TERMINAL_OPS",
                 "STREAMING_OPS", "ADDR_BITS", "MAX_SITES"):
        assert getattr(isa, name) == getattr(jisa, name), name


@given(op=st.integers(0, 10), dest=st.integers(0, isa.MAX_SITES - 1),
       value=st.floats(width=32, allow_nan=False),
       nop=st.integers(0, 10), ndest=st.integers(0, isa.MAX_SITES - 1))
@settings(max_examples=200, deadline=None)
def test_pack_unpack_roundtrip(op, dest, value, nop, ndest):
    m = TorchSide.make(op, dest, value, nop, ndest)
    word = isa.pack_word(m)
    assert word == jisa.pack_word(jisa.Message.make(op, dest, value, nop,
                                                    ndest))
    m2 = isa.unpack_word(word, device=CPU)
    assert int(m2.opcode) == op and int(m2.dest) == dest
    assert int(m2.next_opcode) == nop and int(m2.next_dest) == ndest
    assert np.float32(value) == np.float32(m2.value)


@given(word=st.integers(0, 2**64 - 1))
@settings(max_examples=200, deadline=None)
def test_word_roundtrip(word):
    """Every 64-bit word survives, NaN payloads included (the value's bits
    go through an int32 view, never a float cast), and decodes to the JAX
    package's fields."""
    m = isa.unpack_word(word, device=CPU)
    assert isa.pack_word(m) == word
    assert_same_bits(tree(m), tree(jisa.unpack_word(word)))


def test_vectorized_pack():
    ops = [isa.PROG, isa.A_MULS, isa.UPDATE]
    args = (ops, [1, 2, 3], [1.5, -2.0, 0.0], [isa.A_ADD] * 3, [7, 8, 9])
    m = isa.Message.make(*(torch.tensor(a) for a in args))
    lo, hi = isa.pack(m)
    jlo, jhi = jisa.pack(jisa.Message.make(*(jnp.array(a) for a in args)))
    assert np.array_equal(lo.numpy(), np.asarray(jlo).astype(np.int64))
    assert np.array_equal(hi.numpy(), np.asarray(jhi).astype(np.int64))
    assert_same_bits(tree(isa.unpack(lo, hi)), tree(m))


@pytest.mark.parametrize("fn", ["terminal_result", "streaming_result"])
@pytest.mark.parametrize("op", range(16))
def test_alu_matches_jax(fn, op):
    """Every opcode (the four unused codes included) through both ALUs on
    seeded operands, zeros among the incoming values: the selected branch
    is bit-equal to the JAX package's, and a division by zero in a branch
    that is not taken leaves no trace."""
    rng = np.random.default_rng(op)
    stored = rng.standard_normal(64).astype(np.float32)
    incoming = rng.standard_normal(64).astype(np.float32)
    incoming[::8] = 0.0
    opcode = np.full(64, op, np.int32)
    got = getattr(isa, fn)(*map(torch.from_numpy, (opcode, stored,
                                                    incoming)))
    want = getattr(jisa, fn)(*map(jnp.asarray, (opcode, stored, incoming)))
    assert_same_bits(got.numpy(), np.asarray(want))
    if op not in (isa.A_DIV, isa.A_DIVS):
        assert bool(torch.isfinite(got).all())


def test_alu_semantics():
    t = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt)
    stored, inc = t(10.0), t(4.0)
    op = lambda o: t(o, torch.int32)
    assert float(isa.terminal_result(op(isa.A_ADD), stored, inc)) == 14.0
    assert float(isa.terminal_result(op(isa.A_SUB), stored, inc)) == 6.0
    assert float(isa.terminal_result(op(isa.A_MUL), stored, inc)) == 40.0
    assert float(isa.terminal_result(op(isa.A_DIV), stored, inc)) == 2.5
    assert float(isa.terminal_result(op(isa.UPDATE), stored, inc)) == 4.0
    assert float(isa.streaming_result(op(isa.A_MULS), stored, inc)) == 40.0
    assert float(isa.streaming_result(op(isa.A_SUBS), stored, inc)) == -6.0


def test_message_stack_and_shape():
    msgs = [TorchSide.make(isa.PROG, i, float(i), isa.A_ADD, 2 * i)
            for i in range(3)]
    s = isa.stack(msgs)
    assert s.shape == (3,) and s.opcode.dtype == torch.int32
    assert s.value.dtype == torch.float32
    assert s.is_live().tolist() == [True] * 3
    assert_same_bits(tree(s), tree(JaxSide.stack(
        [jisa.Message.make(isa.PROG, i, float(i), isa.A_ADD, 2 * i)
         for i in range(3)])))


def test_creators_default_to_the_card(monkeypatch):
    """Without a device the creators ask for the card, and raise without
    one: the port never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: fabric.Fabric.create(4, 4),
                 lambda: isa.Message.make(isa.PROG, 1, 1.0),
                 lambda: isa.Message.empty((4,)),
                 lambda: isa.from_hex("00f44121999a0051"),
                 lambda: fabric.addresses(4, 4),
                 lambda: schedule.matvec(np.ones((2, 2)), np.ones(2))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # a tensor's device wins
    m = isa.Message.make(torch.tensor([1, 2]), 3, 1.0)
    assert m.opcode.device == CPU


# --------------------------------------------------------------------- #
# tests/test_fabric.py — hop mode, bit for bit                          #
# --------------------------------------------------------------------- #
def test_addresses_row_major():
    a = both(lambda s: s.addresses(4, 4))
    assert a[1, 1] == 5 and a[2, 1] == 9      # Fig. 5's site & neighbour
    assert a[0, 1] == 1 and a[1, 0] == 4 and a[1, 2] == 6


@pytest.mark.parametrize("rows,cols,fits", [(64, 65, True), (65, 66, False),
                                            (1, 4097, True), (1, 4098, False)])
def test_address_space(rows, cols, fits):
    """12 bits address 4096 sites, the adder column apart: 64 x 65 fits,
    65 x 66 does not, in both packages."""
    for side in SIDES:
        if fits:
            assert tuple(side.create(rows, cols).values.shape) == (rows, cols)
        else:
            with pytest.raises(ValueError, match="address space"):
                side.create(rows, cols)


def fig2(s):
    """Fig. 2: three sites programmed with 1.1/1.2/1.3, streamed A_MULS
    with 1/2/3, results accumulated at site 3 -> 7.4."""
    prog = [s.make(isa.PROG, 2, 1.3, isa.UPDATE, 3),
            s.make(isa.PROG, 1, 1.2, isa.A_ADD, 3),
            s.make(isa.PROG, 0, 1.1, isa.A_ADD, 3)]
    mul = [s.make(isa.A_MULS, 2, 3.0), s.make(isa.A_MULS, 1, 2.0),
           s.make(isa.A_MULS, 0, 1.0)]
    left = s.stack([s.put(s.empty((1,)), 0, m) for m in prog + mul])
    fin, trace = s.run(s.create(1, 4), left, s.empty((6, 4)),
                       extra_cycles=10)
    np.testing.assert_allclose(_np(fin.values)[0, :3], [1.1, 1.2, 1.3],
                               rtol=1e-6)
    assert float(fin.values[0, 3]) == pytest.approx(7.4, rel=1e-6)
    assert int(fin.conflicts) == 0
    return fin, trace


FIG5_TOPS = ["00f44111999a0091", "00f44101999a0091", "00f440e333330091",
             "00d7404000000091", "00f440c333330091"]


def fig5_testbench(s):
    """Fig. 5: 4x4 grid; site 5 receives LEFT-1 (dest=5 -> decoded
    locally) and TOP-1..5 (dest=9 -> forwarded down)."""
    tops = [s.from_hex(h) for h in FIG5_TOPS]
    T = len(tops)
    left = s.put(s.empty((T, 4)), (0, 1), s.from_hex("00f44121999a0051"))
    top = s.stack([s.put(s.empty((4,)), 1, m) for m in tops])
    fin, (right, down) = s.run(s.create(4, 4), left, top, extra_cycles=6)
    assert float(fin.values[1, 1]) == pytest.approx(10.1, rel=1e-6)
    assert int(fin.next_opcode[1, 1]) == isa.A_ADD
    assert int(fin.next_dest[1, 1]) == 15
    assert float(fin.values[2, 1]) == pytest.approx(6.1, rel=1e-6)
    ops, vals = _np(down.opcode)[:, 1, 1], _np(down.value)[:, 1, 1]
    carried = [float(v) for o, v in zip(ops, vals) if o == isa.PROG]
    assert carried == pytest.approx([9.1, 8.1, 7.1, 3.0, 6.1], rel=1e-5)
    assert int(fin.conflicts) == 0
    return fin, (right, down)


def fig5_down_wire(s):
    """The DownMessage probe of Fig. 5 shows each TOP value leaving site
    5's bottom port, in injection order."""
    vals = [9.1, 8.1, 7.1, 3.0, 6.1]
    top = s.stack([s.put(s.empty((4,)), 1, s.make(isa.PROG, 9, v,
                                                  isa.A_ADD, 15))
                   for v in vals])
    fin, (right, down) = s.run(s.create(4, 4), s.empty((5, 4)), top,
                               extra_cycles=4)
    ops, dv = _np(down.opcode)[:, 1, 1], _np(down.value)[:, 1, 1]
    assert [float(v) for o, v in zip(ops, dv) if o == isa.PROG] == (
        pytest.approx(vals))
    assert int(fin.conflicts) == 0
    return fin, (right, down)


def torus_right(s):
    """A message reaches a destination to its left by wrapping: 3->4->0->1."""
    left = s.stack([s.put(s.empty((1,)), 0, s.make(isa.UPDATE, 3, 33.0))])
    fin, tr1 = s.run(s.create(1, 5), left, s.empty((1, 5)), extra_cycles=6)
    assert float(fin.values[0, 3]) == pytest.approx(33.0)
    seq2 = [s.make(isa.PROG, 3, 33.0, isa.UPDATE, 1),
            s.make(isa.A_MULS, 3, 2.0)]
    left2 = s.stack([s.put(s.empty((1,)), 0, m) for m in seq2])
    fin2, tr2 = s.run(fin, left2, s.empty((2, 5)), extra_cycles=8)
    assert float(fin2.values[0, 1]) == pytest.approx(66.0)
    assert int(fin2.conflicts) == 0
    return fin, tr1, fin2, tr2


def torus_down(s):
    seq = [s.make(isa.PROG, 8, 5.0, isa.UPDATE, 2),
           s.make(isa.A_ADDS, 8, 1.0)]
    top = s.stack([s.put(s.empty((3,)), 2, m) for m in seq])
    fin, trace = s.run(s.create(3, 3), s.empty((2, 3)), top, extra_cycles=8)
    assert float(fin.values[0, 2]) == pytest.approx(6.0)
    assert int(fin.conflicts) == 0
    return fin, trace


def message_conservation(s):
    """Live messages are never duplicated: deliveries == injections."""
    msgs = [s.make(isa.A_ADD, (3 * 4 + i) % 16, 1.0) for i in range(4)]
    top = s.stack([s.put(s.empty((4,)), i, m) for i, m in enumerate(msgs)])
    fin, trace = s.run(s.create(4, 4), s.empty((4, 4)), top,
                       extra_cycles=12)
    assert float(_np(fin.values).sum()) == pytest.approx(4.0)
    assert int(fin.conflicts) == 0
    return fin, trace


@pytest.mark.parametrize("case", [fig2, fig5_testbench, fig5_down_wire,
                                  torus_right, torus_down,
                                  message_conservation],
                         ids=lambda c: c.__name__)
def test_hop_case_bit_equal(case):
    """The case's own assertions in each package, then every cycle's
    right / down wires and the final state equal bit for bit."""
    both(case)


@given(r=st.integers(0, 3), c=st.integers(0, 3), value=st.floats(
    min_value=-1e3, max_value=1e3, allow_nan=False, width=32))
@settings(max_examples=25, deadline=None)
def test_any_site_reachable_from_top(r, c, value):
    """A message injected at the top edge reaches ANY site."""
    def case(s):
        m = s.make(isa.UPDATE, r * 4 + c, value)
        top = s.stack([s.put(s.empty((4,)), c, m)])
        fin, trace = s.run(s.create(4, 4), s.empty((1, 4)), top,
                           extra_cycles=10)
        assert float(fin.values[r, c]) == pytest.approx(np.float32(value),
                                                        rel=1e-6)
        assert int(fin.conflicts) == 0
        return fin, trace
    both(case)


# --------------------------------------------------------------------- #
# random hop-mode streams from one carried state                        #
# --------------------------------------------------------------------- #
def _random_msgs(rng, shape, n_sites, live=0.5):
    """Seeded messages: a share ``live`` of them carry an opcode of the
    ISA (streaming ones among them), destinations anywhere on the fabric,
    values away from 0 so no quotient overflows."""
    op = rng.integers(1, 11, shape).astype(np.int32)
    op[rng.random(shape) >= live] = isa.NOP
    mag = rng.uniform(0.5, 2.0, shape) * rng.choice([-1.0, 1.0], shape)
    return {"opcode": op,
            "dest": rng.integers(0, n_sites, shape).astype(np.int32),
            "value": mag.astype(np.float32),
            "next_opcode": rng.integers(1, 11, shape).astype(np.int32),
            "next_dest": rng.integers(0, n_sites, shape).astype(np.int32)}


def _random_state(rng, rows, cols):
    n = rows * cols
    return {"values": (rng.uniform(0.5, 2.0, (rows, cols))
                       * rng.choice([-1.0, 1.0], (rows, cols))
                       ).astype(np.float32),
            "next_opcode": rng.integers(1, 11, (rows, cols)).astype(np.int32),
            "next_dest": rng.integers(0, n, (rows, cols)).astype(np.int32),
            "right": _random_msgs(rng, (rows, cols), n),
            "down": _random_msgs(rng, (rows, cols), n),
            "conflicts": np.zeros((), np.int32)}


def _jax_message(a):
    return jisa.Message(**{k: jnp.asarray(v) for k, v in a.items()})


def _jax_fabric(a):
    return jfabric.Fabric(
        values=jnp.asarray(a["values"]),
        next_opcode=jnp.asarray(a["next_opcode"]),
        next_dest=jnp.asarray(a["next_dest"]),
        right=_jax_message(a["right"]), down=_jax_message(a["down"]),
        conflicts=jnp.asarray(a["conflicts"]))


@pytest.mark.parametrize("rows,cols,seed", [(4, 4, 0), (4, 4, 1),
                                            (8, 9, 2), (8, 9, 3)])
def test_random_stream_bit_equal(rows, cols, seed):
    """A random programmed state with messages on every wire, and random
    injections at both edges (terminal and streaming ops, wraps round the
    torus, port conflicts): every cycle's wires, the final state and the
    conflict count equal the JAX package's bit for bit."""
    rng = np.random.default_rng(seed)
    T, n = 12, rows * cols
    start = _random_state(rng, rows, cols)
    left, top = (_random_msgs(rng, (T, k), n, live=0.7)
                 for k in (rows, cols))
    want = _jax_run(_jax_fabric(start), _jax_message(left),
                    _jax_message(top), extra_cycles=2 * (rows + cols))
    got = fabric.run(fabric_from_numpy(start, device=CPU),
                     message_from_numpy(left, device=CPU),
                     message_from_numpy(top, device=CPU),
                     extra_cycles=2 * (rows + cols))
    assert_same_bits(tree(got), tree(want))
    fin = got[0]
    assert (_np(got[1][0].opcode) != isa.NOP).any() and int(fin.conflicts) > 0
    assert not np.array_equal(_np(fin.values), start["values"])


def test_step_leaves_its_input_untouched():
    """A cycle builds new tensors: the state it was given, and so every
    slot of a trace, keeps its bits."""
    rng = np.random.default_rng(5)
    start = _random_state(rng, 4, 4)
    state = fabric_from_numpy(start, device=CPU)
    before = tree(state)
    inj = _random_msgs(rng, (4,), 16, live=1.0)
    fabric.step(state, message_from_numpy(inj, device=CPU),
                message_from_numpy(inj, device=CPU))
    assert_same_bits(tree(state), before)


def test_fabric_from_numpy_roundtrips_a_jax_state():
    rng = np.random.default_rng(7)
    start = _random_state(rng, 4, 5)
    jstate, _ = _jax_run(_jax_fabric(start),
                         _jax_message(_random_msgs(rng, (3, 4), 20)),
                         _jax_message(_random_msgs(rng, (3, 5), 20)),
                         extra_cycles=1)
    arrays = tree(jstate)
    state = fabric_from_numpy(arrays, device=CPU)
    assert_same_bits(tree(state), arrays)
    assert state.shape == (4, 5) and state.device == CPU
    msg = message_from_numpy(tree(jstate.right), device=CPU)
    assert_same_bits(tree(msg), arrays["right"])
    bad = dict(arrays, values=arrays["values"].astype(np.float64))
    with pytest.raises(ValueError, match="values is torch.float64"):
        fabric_from_numpy(bad, device=CPU)


# --------------------------------------------------------------------- #
# bus mode                                                              #
# --------------------------------------------------------------------- #
def test_bus_mode_batches_over_leading_dims():
    """A stack of fabrics takes one bus pass; each equals its own pass, and
    the JAX package's, bit for bit."""
    rng = np.random.default_rng(11)
    blocks = rng.standard_normal((2, 3, 4, 3)).astype(np.float32)
    vecs = rng.standard_normal((3, 5)).astype(np.float32)
    st_ = fabric.load_values(fabric.Fabric.create(4, 5, CPU),
                             torch.from_numpy(blocks))
    assert st_.shape == (2, 3, 4, 5)
    mul = fabric.vbus_mul(st_, torch.from_numpy(vecs))
    sums = fabric.hbus_reduce_rows(mul, ncols=3)
    for i in range(2):
        for j in range(3):
            one = jfabric.load_values(jfabric.Fabric.create(4, 5),
                                      jnp.asarray(blocks[i, j]))
            one = jfabric.vbus_mul(one, jnp.asarray(vecs[j]))
            assert_same_bits(mul.values[i, j].numpy(), np.asarray(one.values))
            np.testing.assert_allclose(
                sums[i, j].numpy(),
                np.asarray(jfabric.hbus_reduce_rows(one, ncols=3)),
                rtol=1e-6)
    sl = fabric.vbus_mul(st_, torch.from_numpy(vecs[0]), cols_slice=slice(1, 3))
    want = jfabric.vbus_mul(
        jfabric.load_values(jfabric.Fabric.create(4, 5),
                            jnp.asarray(blocks[0, 0])),
        jnp.asarray(vecs[0]), cols_slice=slice(1, 3))
    assert_same_bits(sl.values[0, 0].numpy(), np.asarray(want.values))


# --------------------------------------------------------------------- #
# tests/test_schedule.py                                                #
# --------------------------------------------------------------------- #
def _ab(N, M, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, M)).astype(np.float32),
            rng.standard_normal(M).astype(np.float32))


@pytest.mark.parametrize("N,M", [(4, 3), (6, 5), (8, 8), (16, 4), (3, 16)])
def test_matvec_numerics_and_steps(N, M):
    A, b = _ab(N, M, N * 31 + M)
    res = TorchSide.matvec(A, b)
    np.testing.assert_allclose(res.result.numpy(), A @ b, rtol=2e-5,
                               atol=1e-5)
    assert res.steps == timing.matvec_steps(N) == N + 3
    want = JaxSide.matvec(A, b)
    np.testing.assert_allclose(res.result.numpy(), np.asarray(want.result),
                               rtol=1e-6)
    assert res.steps == int(want.steps)


@pytest.mark.parametrize("N,M", [(4, 3), (6, 5), (8, 8)])
def test_matvec_message_mode_matches_fast_mode(N, M):
    """Hop mode (real Prog messages) and direct load give identical
    results; the hop-mode load equals the JAX package's bit for bit."""
    A, b = _ab(N, M, 7)
    fast = TorchSide.matvec(A, b, use_messages=False)
    slow = TorchSide.matvec(A, b, use_messages=True)
    np.testing.assert_allclose(fast.result.numpy(), slow.result.numpy(),
                               rtol=1e-6)
    assert int(slow.state.conflicts) == 0
    assert fast.steps == slow.steps
    want = JaxSide.matvec(A, b, use_messages=True)
    np.testing.assert_allclose(slow.result.numpy(), np.asarray(want.result),
                               rtol=1e-6)
    # the fabric after the hop-mode load and the bus passes: the matrix
    # sites and the programmed registers equal the JAX package's bits
    got, exp = tree(slow.state), tree(want.state)
    for k in ("next_opcode", "next_dest", "conflicts", "right", "down"):
        assert_same_bits(got[k], exp[k], k)
    assert_same_bits(got["values"][:, :-1], exp["values"][:, :-1])


def test_fig3_worked_example():
    """Fig. 3's 4x3 example: steps = N+3 = 7."""
    A = np.arange(12, dtype=np.float32).reshape(4, 3)
    b = np.array([1.0, 2.0, 3.0], np.float32)
    for use_messages in (False, True):
        res = TorchSide.matvec(A, b, use_messages=use_messages)
        np.testing.assert_array_equal(res.result.numpy(), A @ b)
        assert res.steps == 7


def _column_stochastic(N, seed, sparse=False):
    rng = np.random.default_rng(seed)
    H = rng.random((N, N)).astype(np.float32)
    if sparse:
        H = H * (rng.random((N, N)) > 0.5) + np.float32(1e-3)
    return (H / H.sum(axis=0, keepdims=True)).astype(np.float32)


def test_pagerank_iteration_steps():
    N = 8
    H = _column_stochastic(N, 0)
    pr = np.full((N,), 1.0 / N, np.float32)
    res = schedule.pagerank_iteration(torch.from_numpy(H),
                                      torch.from_numpy(pr), d=0.85)
    assert res.steps == timing.pagerank_iteration_steps(N) == N + 6
    np.testing.assert_allclose(res.result.numpy(),
                               0.85 * (H @ pr) + 0.15 / N, rtol=1e-6)
    want = jschedule.pagerank_iteration(jnp.asarray(H), jnp.asarray(pr))
    np.testing.assert_allclose(res.result.numpy(), np.asarray(want.result),
                               rtol=1e-6)
    assert res.steps == int(want.steps)


@pytest.mark.parametrize("use_messages,iters", [(False, 25), (True, 2)])
def test_pagerank_multi_iteration_matches_reference(use_messages, iters):
    N = 10
    H = _column_stochastic(N, 3, sparse=True)
    pr_t, steps, secs = pagerank_on_fabric(torch.from_numpy(H),
                                           n_iters=iters,
                                           use_messages=use_messages)
    pr = np.full((N,), 1.0 / N, np.float32)
    for _ in range(iters):
        pr = 0.85 * (H @ pr) + 0.15 / N
    np.testing.assert_allclose(pr_t.numpy(), pr, rtol=1e-4)
    assert steps == iters * (N + 6)
    jpr, jsteps, jsecs = j_pagerank_on_fabric(jnp.asarray(H), n_iters=iters,
                                              use_messages=use_messages)
    np.testing.assert_allclose(pr_t.numpy(), np.asarray(jpr), rtol=1e-6)
    assert (steps, secs) == (jsteps, jsecs)


def test_pagerank_keeps_the_4096_site_limit():
    """The untiled schedule fits N <= 64 only, and raises beyond, as in the
    JAX package."""
    H = _column_stochastic(65, 1)
    for run in (lambda: schedule.pagerank(torch.from_numpy(H), n_iters=1),
                lambda: jschedule.pagerank(jnp.asarray(H), n_iters=1)):
        with pytest.raises(ValueError, match="address space"):
            run()
    res = schedule.pagerank(torch.from_numpy(_column_stochastic(64, 1)),
                            n_iters=1)
    assert res.state.shape == (64, 65) and res.steps == 70


@given(n=st.integers(2, 12), m=st.integers(2, 12))
@settings(max_examples=20, deadline=None)
def test_matvec_steps_independent_of_columns(n, m):
    """Fig. 6A: latency depends on rows only, not columns."""
    res = schedule.matvec(torch.ones((n, m)), torch.ones(m))
    assert res.steps == n + 3 == jtiming.matvec_steps(n)
    assert res.result.tolist() == [float(m)] * n


def _tiled_case(n, iters):
    src, dst = protein_network(n, seed=1)
    jsrc, jdst = jgen.protein_network(n, seed=1)
    assert np.array_equal(src, jsrc) and np.array_equal(dst, jdst)
    H = build_transition_dense(src, dst, n, device=CPU)
    return H, jtr.build_transition_dense(jsrc, jdst, n)


@pytest.mark.parametrize("n,iters", [(150, 20), (130, 20)])
def test_pagerank_tiled_matches_jax(n, iters):
    """Fig. 4C at quickstart's size (N = 150, 3 x 3 tiles) and at N = 130
    (partial tiles): the batched bus passes equal the JAX package's
    pass-by-pass run and the dense reference, with the paper's exact
    step accounting (ceil(N^2/S) tiles x (sqrt(S)+6))."""
    H, jH = _tiled_case(n, iters)
    res = schedule.pagerank_tiled(H, n_iters=iters)
    want = jschedule.pagerank_tiled(jH, n_iters=iters)
    np.testing.assert_allclose(res.result.numpy(), np.asarray(want.result),
                               rtol=1e-5, atol=1e-7)
    assert res.steps == int(want.steps) == (
        iters * timing.pagerank_tiles(n) * 70)
    pr = np.full((n,), 1.0 / n, np.float32)
    Hn = H.numpy()
    for _ in range(iters):
        pr = 0.85 * (Hn @ pr) + 0.15 / n
    np.testing.assert_allclose(res.result.numpy(), pr, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        res.result.numpy(), pagerank_dense_fixed(H, iters).numpy(),
        rtol=1e-4, atol=1e-7)


def test_pagerank_tiled_step_count_headline():
    """The tiled accounting at N=5000, 100 iters equals the 213.6 ms cycle
    count (42.728M cycles), in both packages' models."""
    assert timing.pagerank_steps_tiled(5000, 100) == 42_728_000 == (
        jtiming.pagerank_steps_tiled(5000, 100))


# --------------------------------------------------------------------- #
# examples/torch_quickstart.py                                          #
# --------------------------------------------------------------------- #
def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(lines, key):
    return [ln for ln in lines if key in ln]


def test_quickstart_prints_the_jax_example():
    """The port's quickstart on the CPU exits 0 and prints the JAX
    example's step counts, top-5 proteins and headline."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _load_example("torch_quickstart").main(["--device", "cpu"])
    got = buf.getvalue().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(ROOT, "examples", "quickstart.py"),
                       run_name="__main__")
    want = buf.getvalue().splitlines()
    assert rc == 0 and got[-1] == want[-1] == "quickstart: ALL OK"
    for key in ("->", "A@b =", "fabric steps:", "top-5 proteins:",
                "tiled result == dense reference", "5000 proteins"):
        assert _printed(got, key) == _printed(want, key), key
        assert _printed(got, key)
