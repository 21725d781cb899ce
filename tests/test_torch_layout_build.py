"""PyTorch port, the ``ell`` layouts built on the engine's device: the
transition CSR from one sort of the edge set's transposed keys, the split
ELL by scatters, the storage dtype applied there.  On every precision the
operands, the dangling mask, the ``layout`` string and ``layout_bytes``
equal, bit for bit, the host build the engine made before: the numpy
transition CSR of ``tr.build_transition_csr``, then the split ELL and its
quantization as numpy code (copied below as the reference); ``ell_sharded``
equals its host full-width rows.  The last tests run the build on the card
against the CPU build and skip without one (marker ``cuda``)."""
import numpy as np
import pytest
import torch

from repro_torch.graph import transition as tr
from repro_torch.graph.delta import dedupe_directed
from repro_torch.graph.generators import protein_network
from repro_torch.graph.sparse import ELLMatrix
from repro_torch.launch.mesh import make_mesh
from repro_torch.obs.registry import NullRegistry
from repro_torch.pagerank import PageRankEngine
from repro_torch.pagerank.engine import HOT_COLUMNS
from repro_torch.pagerank.precision import (PRECISIONS, STORAGE_DTYPES,
                                            layout_nbytes, quantize_int8,
                                            rowmax_scales)


def _cases():
    rng = np.random.default_rng(30)
    n = 300
    # sources below 250 (50 dangling vertices), targets from 20 (20 empty
    # rows), two hub rows far past k0, self-loops and repeated edges
    s = rng.integers(0, 250, 1500)
    d = rng.integers(20, n, 1500)
    hub_s = rng.integers(0, 250, 180)
    s = np.concatenate([s, hub_s, hub_s[:70], [3, 9, 9], s[:200]])
    d = np.concatenate([d, np.full(180, 7), np.full(70, 11), [3, 9, 9],
                        d[:200]])
    ps, pd = protein_network(400, seed=12)
    big_s = rng.integers(0, 70_000, 50_000)
    big_d = (rng.zipf(1.6, 50_000) - 1) % 70_000      # keys past 2**31
    return {
        "hubs": (s.astype(np.int32), d.astype(np.int32), n),
        "protein": (ps, pd, 400),
        "tiny": (np.array([0, 1, 0, 2, 1, 0], np.int32),
                 np.array([1, 2, 1, 0, 2, 1], np.int32), 3),
        "empty": (np.zeros(0, np.int32), np.zeros(0, np.int32), 5),
        "zipf": (big_s.astype(np.int64), big_d.astype(np.int64), 70_000),
    }


CASES = _cases()


def _split_ell_host(csr, n, k0=None):
    """The engine's split ELL as numpy built it."""
    counts = np.diff(csr.indptr.numpy())
    if k0 is None:
        k0 = max(4, int(np.percentile(counts, 90))) if len(counts) else 4
    cols = csr.indices.numpy()
    vals = csr.data.numpy()
    rows, pos = csr.row_positions()
    in_ell = pos < k0
    data = np.zeros((n, k0), np.float32)
    idx = np.zeros((n, k0), np.int32)
    data[rows[in_ell], pos[in_ell]] = vals[in_ell]
    idx[rows[in_ell], pos[in_ell]] = cols[in_ell]
    ov = ~in_ell
    return (data, idx, rows[ov].astype(np.int32), cols[ov].astype(np.int32),
            vals[ov].astype(np.float32)), k0, int(ov.sum())


def _quantize_split_ell_host(ops, precision):
    """The engine's storage dtype as numpy applied it, before the upload."""
    data, idx, ov_r, ov_c, ov_v = ops
    t = torch.from_numpy
    if precision != "int8":
        dt = STORAGE_DTYPES[precision]
        return (t(data).to(dt), t(idx), t(ov_r), t(ov_c), t(ov_v).to(dt))
    absmax = np.abs(data).max(axis=1, initial=0.0)
    np.maximum.at(absmax, ov_r, np.abs(ov_v))
    scales = rowmax_scales(absmax)
    return (t(quantize_int8(data, scales[:, None])), t(idx), t(ov_r),
            t(ov_c), t(quantize_int8(ov_v, scales[ov_r])), t(scales))


def _degree_order(src, dst, n):
    """The ``ell`` layout's vertex order as numpy computes it: ``None`` up
    to ``HOT_COLUMNS`` vertices, else the vertices by out-degree,
    descending, ties by id."""
    if n <= HOT_COLUMNS:
        return None
    s, _ = dedupe_directed(src, dst, n, drop_self_loops=False)
    return np.argsort(-np.bincount(s, minlength=n), kind="stable")


def _ell_host(src, dst, n, ell_k, precision, order=None):
    """The split ELL the host built, of the edges relabelled by ``order``
    (layout position -> caller's id) where one is given."""
    s, d = dedupe_directed(src, dst, n, drop_self_loops=False)
    if order is not None:
        pos = np.empty(n, np.int64)
        pos[order] = np.arange(n)
        s, d = pos[s], pos[d]
    csr = tr.build_transition_csr(s, d, n, device="cpu")
    ops, k0, ov_nnz = _split_ell_host(csr, n, ell_k)
    layout = f"ell(k0={k0})+overflow(nnz={ov_nnz})"
    if precision != "f32":
        layout = f"{layout}[{precision}]"
    dang = torch.from_numpy(tr.dangling_mask(s, n).astype(np.float32))
    return _quantize_split_ell_host(ops, precision), dang, layout


def _full_ell_host(src, dst, n, n_pad, precision):
    """``ell_sharded``'s global rows, scales and mask as the host built
    them."""
    s, d = dedupe_directed(src, dst, n, drop_self_loops=False)
    csr = tr.build_transition_csr(s, d, n, device="cpu")
    counts = np.diff(csr.indptr.numpy())
    ell = ELLMatrix.from_csr(csr, k=int(counts.max()) if len(counts) else 0)
    vals = np.zeros((n_pad, ell.k), np.float32)
    idx = np.zeros((n_pad, ell.k), np.int32)
    vals[:n] = ell.data.numpy()
    idx[:n] = ell.indices.numpy()
    scales = None
    if precision == "int8":
        scales = torch.from_numpy(
            rowmax_scales(np.abs(vals).max(axis=1, initial=0.0)))
        vals = quantize_int8(vals, scales.numpy()[:, None])
    dang = np.zeros(n_pad, np.float32)
    dang[:n] = tr.dangling_mask(s, n)
    vals = torch.from_numpy(vals).to(STORAGE_DTYPES[precision])
    return (vals, torch.from_numpy(idx)), scales, torch.from_numpy(dang), \
        ell.k


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu().contiguous()
    if t.dtype.is_floating_point:
        return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])
    return t


def _assert_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


def _engine(src, dst, n, **kw):
    if kw.get("mesh") is None:
        kw.setdefault("device", "cpu")
    return PageRankEngine(src, dst, n, metrics=NullRegistry(), **kw)


def _sharded_state(eng):
    ops = tuple(o.full() for o in eng.operands)
    scales = None if eng._scales is None else eng._scales.full()
    return ops, scales, eng._dang.full()


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("ell_k", [None, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_the_ell_layout_equals_the_host_build(case, ell_k, precision):
    src, dst, n = CASES[case]
    eng = _engine(src, dst, n, backend="ell", ell_k=ell_k,
                  precision=precision)
    order = _degree_order(src, dst, n)
    assert (eng.vertex_order is None) == (order is None)
    if order is not None:
        assert np.array_equal(eng.vertex_order.numpy(), order)
    ops, dang, layout = _ell_host(src, dst, n, ell_k, precision, order)
    _assert_bits(eng.operands, ops)
    _assert_bits((eng._dang,), (dang,))
    assert eng.layout == layout
    assert eng.layout_bytes == layout_nbytes(ops)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", ["hubs", "protein", "tiny"])
def test_the_ell_sharded_layout_equals_the_host_build(case, precision):
    src, dst, n = CASES[case]
    mesh = make_mesh((4,), ("shard",), ["cpu"] * 4)
    eng = _engine(src, dst, n, backend="ell_sharded", mesh=mesh,
                  precision=precision)
    n_pad = -(-n // 4) * 4
    ops, scales, dang, k = _full_ell_host(src, dst, n, n_pad, precision)
    got_ops, got_scales, got_dang = _sharded_state(eng)
    _assert_bits(got_ops, ops)
    _assert_bits((got_dang,), (dang,))
    assert (got_scales is None) == (scales is None)
    if scales is not None:
        _assert_bits((got_scales,), (scales,))
    assert eng.layout.startswith(f"ell_sharded(k={k}, shards=4, "
                                 f"n_pad={n_pad})")


@pytest.mark.parametrize("backend", ["ell", "ell_sharded"])
def test_a_rebuild_from_the_host_edges_equals_the_constructors(backend):
    """The dynamic engine rebuilds from host edges alone: the layout
    uploads them and builds the same operands."""
    src, dst, n = CASES["hubs"]
    mesh = (make_mesh((4,), ("shard",), ["cpu"] * 4)
            if backend == "ell_sharded" else None)
    eng = _engine(src, dst, n, backend=backend, mesh=mesh, precision="int8")
    before = (_sharded_state(eng) if mesh is not None
              else (eng.operands, None, eng._dang))
    layout = eng.layout
    s, d = dedupe_directed(src, dst, n, drop_self_loops=False)
    eng._prepare_layout(s, d)
    after = (_sharded_state(eng) if mesh is not None
             else (eng.operands, None, eng._dang))
    _assert_bits(after[0], before[0])
    _assert_bits((after[2],), (before[2],))
    if mesh is not None:
        _assert_bits((after[1],), (before[1],))
    assert eng.layout == layout


def _card_cases():
    rng = np.random.default_rng(31)
    n = 200_000
    s = rng.integers(0, n - 1000, 3_000_000)
    d = (rng.zipf(1.4, 3_000_000) * 7919) % n           # hub rows
    return {**CASES, "powerlaw": (s, d, n)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_the_ell_layout_on_the_card_equals_the_cpu_build(precision):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the layout's card path")
    for case, (src, dst, n) in _card_cases().items():
        for ell_k in (None, 3):
            card = _engine(src, dst, n, device="cuda", backend="ell",
                           ell_k=ell_k, precision=precision)
            cpu = _engine(src, dst, n, backend="ell", ell_k=ell_k,
                          precision=precision)
            assert card.operands[0].device.type == "cuda", case
            _assert_bits(card.operands, cpu.operands)
            _assert_bits((card._dang,), (cpu._dang,))
            assert card.layout == cpu.layout
            assert card.layout_bytes == cpu.layout_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_the_ell_sharded_layout_on_the_card_equals_the_cpu_build(precision):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the layout's card path")
    for case in ("hubs", "protein", "tiny"):
        src, dst, n = CASES[case]
        got = [_sharded_state(_engine(
            src, dst, n, backend="ell_sharded", precision=precision,
            mesh=make_mesh((4,), ("shard",), [dev] * 4)))
            for dev in ("cuda:0", "cpu")]
        card, cpu = got
        assert card[0][0].device.type == "cuda", case
        _assert_bits(card[0], cpu[0])
        _assert_bits((card[2],), (cpu[2],))
        if precision == "int8":
            _assert_bits((card[1],), (cpu[1],))
