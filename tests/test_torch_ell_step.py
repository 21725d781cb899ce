"""PyTorch port, the split-ELL step of the ``ell`` tier on the CPU: the
plain version of the card's kernel (``kernels/ell_step.ell_step_ref``,
what ``ell_step`` runs on CPU tensors) against today's eager step,
the ``ell`` tier's eager product then ``sparse_step``, and the metadata
``ell_meta`` builds beside the operands.

The eager step adds a row's overflow in one sequential ``index_add_``; the
plain version sums it as the kernel does, by runs of ``RUN`` entries,
chunks of ``CHUNK``, then chunk by chunk.  On rows without overflow both take the same
sum (rtol 1e-6).  On a hub row the two orders part: a sequential sum of
thousands of float32 terms drifts from the exact sum by up to 3.4e-4 of
it here, so every row is held to the step computed in float64 on the same
operands instead: the plain version lies no farther from it than the eager
step does, give or take 1e-6 of its value.  The card's kernel is held to
this plain version in ``tests/test_torch_cuda.py``."""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.kernels.ell_step import (CHUNK, ROWS_PER_BLOCK, ell_meta,
                                          ell_step, ell_step_ref)
from repro_torch.obs.registry import NullRegistry
from repro_torch.pagerank import PageRankEngine
from repro_torch.pagerank.convert import layout_from_numpy
from repro_torch.pagerank.engine import TIERS
from repro_torch.pagerank.precision import PRECISIONS
from repro_torch.pagerank.steps import sparse_step
from test_torch_layout_build import CASES


def _cases():
    rng = np.random.default_rng(31)
    # a hub row whose 12,000 overflow entries span several chunks, beside
    # the zipf graph's rows
    s, d, n = CASES["zipf"]
    hub = rng.choice(60_000, 12_000, replace=False)
    return {**CASES, "chunks": (np.concatenate([s, hub]),
                                np.concatenate([d, np.full(12_000, 5)]), n)}


GRAPHS = _cases()


def _engine(case, **kw):
    src, dst, n = GRAPHS[case]
    return PageRankEngine(src, dst, n, backend="ell", device="cpu",
                          metrics=NullRegistry(), **kw)


def _eager(eng, x, operands=None):
    ops = eng.operands if operands is None else operands
    return sparse_step(lambda v: TIERS["ell"].product(ops, v), x,
                       eng._dang.to(x.dtype), eng.d, eng.n)


def _plain(eng, x, meta=None):
    meta = eng._ell_meta if meta is None else meta
    return ell_step(eng.operands, meta, eng._dang, x,
                    torch.sum(x * eng._dang), d=eng.d)


def _rank_like(n, seed):
    x = torch.from_numpy(np.random.default_rng(seed).random(n)).float()
    return x / x.sum()


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("ell_k", [None, 3])
@pytest.mark.parametrize("case", list(GRAPHS))
def test_the_plain_step_matches_the_eager_step(case, ell_k, precision):
    eng = _engine(case, ell_k=ell_k, precision=precision)
    n = eng.n
    x = _rank_like(n, seed=n)
    new, leak = _plain(eng, x)
    want = _eager(eng, x)
    assert new.dtype == torch.float32 and new.shape == (n,)
    assert torch.equal(leak, torch.sum(new * eng._dang))
    plain = torch.ones(n, dtype=torch.bool)
    plain[eng._ell_meta.ov_rows.long()] = False
    torch.testing.assert_close(new[plain], want[plain], rtol=1e-6, atol=0)
    ops64 = tuple(o.double() if o.is_floating_point() else o
                  for o in eng.operands)
    exact = _eager(eng, x.double(), ops64)
    err = (new.double() - exact).abs()
    assert bool((err <= (want.double() - exact).abs()
                 + 1e-6 * exact.abs()).all())


def test_a_hub_row_spans_chunks_and_no_slot_is_shared():
    eng = _engine("chunks")
    meta = eng._ell_meta
    ptr = meta.ov_ptr.long()
    spans = (ptr[1:] - 1) // CHUNK - ptr[:-1] // CHUNK + 1
    assert int(spans.max()) >= 4
    # the (compact row, chunk) pairs of pass 1 own distinct slots r + c
    row = torch.repeat_interleave(torch.arange(len(spans)), ptr.diff())
    chunk = torch.arange(int(ptr[-1])) // CHUNK
    pairs = torch.unique(row * (int(chunk[-1]) + 1) + chunk)
    slots = pairs // (int(chunk[-1]) + 1) + pairs % (int(chunk[-1]) + 1)
    assert torch.unique(slots).numel() == pairs.numel()


@pytest.mark.parametrize("case", list(GRAPHS))
def test_the_metadata_describes_the_layout(case):
    eng = _engine(case)
    data, idx, ov_r, ov_c, ov_v = eng.operands
    n, k0 = data.shape
    meta = eng._ell_meta
    assert all(t.dtype == torch.int32 for t in meta if t is not None)
    src, dst, _ = GRAPHS[case]
    indeg = torch.from_numpy(eng._indeg)
    assert torch.equal(meta.counts, indeg.clamp(max=k0).int())
    # every slot past a row's count is padding: value 0 at index 0
    pad = torch.arange(k0)[None, :] >= meta.counts[:, None]
    assert not bool(data[pad].any()) and not bool(idx[pad].any())
    rows, size = np.unique(ov_r.numpy(), return_counts=True)
    assert np.array_equal(meta.ov_rows.numpy(), rows)
    assert np.array_equal(meta.ov_ptr.numpy(),
                          np.concatenate([[0], np.cumsum(size)]))
    assert bool((indeg[meta.ov_rows.long()] > k0).all())
    E = ov_v.numel()
    for c, r in enumerate(meta.chunk_row.tolist()):
        e = min(c * CHUNK, max(E - 1, 0))
        assert E == 0 or meta.ov_ptr[r] <= e < meta.ov_ptr[r + 1]
    assert meta.chunk_row.numel() == -(-E // CHUNK) + 1
    starts = np.arange(-(-n // ROWS_PER_BLOCK) + 1) * ROWS_PER_BLOCK
    assert np.array_equal(meta.block_ov.numpy(),
                          np.searchsorted(rows, starts))
    assert meta.ticket.tolist() == [0]
    assert meta.nbytes == 4 * (n + 2 * len(rows) + 1
                               + meta.chunk_row.numel()
                               + meta.block_ov.numel() + 1)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_a_carried_layout_reads_every_slot(precision):
    """A layout carried in through ``from_layout`` has no counts: the
    plain step reads all k0 slots and gives the same bits."""
    eng = _engine("hubs", precision=precision)
    ops = [o.float().numpy().astype(ml_dtypes.bfloat16)
           if o.dtype == torch.bfloat16 else o.numpy() for o in eng.operands]
    lay = layout_from_numpy("ell", {"operands": ops, "scales": None,
                                    "dang": eng._dang.numpy()},
                            precision=precision, device="cpu")
    carried = PageRankEngine.from_layout("ell", lay, eng.n,
                                         precision=precision, device="cpu",
                                         metrics=NullRegistry())
    assert carried._ell_meta.counts is None
    assert all(torch.equal(a, b) for a, b in zip(
        carried._ell_meta[1:], eng._ell_meta[1:]))
    x = _rank_like(eng.n, seed=3)
    for a, b in zip(_plain(carried, x), _plain(eng, x)):
        assert torch.equal(a, b)


def test_no_overflow_and_empty_rows():
    """Every row within k0 (no overflow, no pass 1) and rows with no
    entries at all, dangling vertices among them."""
    eng = _engine("hubs", ell_k=400)
    assert eng.operands[2].numel() == 0
    assert eng._ell_meta.ov_ptr.tolist() == [0]
    x = _rank_like(eng.n, seed=4)
    new, leak = _plain(eng, x)
    torch.testing.assert_close(new, _eager(eng, x), rtol=1e-6, atol=0)
    empty = torch.from_numpy(eng._indeg == 0)
    assert bool(empty.any()) and bool(eng._dang.any())
    # an empty row holds the teleport and the leak alone
    base = eng.d * (torch.sum(x * eng._dang) / eng.n) + (1 - eng.d) / eng.n
    assert torch.equal(new[empty], base.expand(int(empty.sum())))


def test_the_overflow_must_be_row_major():
    with pytest.raises(ValueError, match="row-major"):
        ell_meta(torch.tensor([3, 1], dtype=torch.int32), 5)


def test_the_cpu_engine_keeps_its_eager_step():
    """The CPU path of ``run`` is unchanged: bit for bit the eager steps,
    and the kernel's wrapper is never reached."""
    eng = _engine("protein")
    pr = torch.full((eng.n,), 1.0 / eng.n)
    for _ in range(7):
        pr = _eager(eng, pr)
    assert torch.equal(eng.run(7), pr)
    assert eng.run(7).device.type == "cpu"


def test_the_plain_version_needs_no_metadata_beyond_the_layouts():
    """``ell_step_ref`` takes a metadata built from the overflow rows
    alone, as ``ell_meta`` builds it for any layout."""
    eng = _engine("protein", precision="int8")
    meta = ell_meta(eng.operands[2], eng.n)
    x = _rank_like(eng.n, seed=5)
    got = ell_step_ref(eng.operands, meta, eng._dang, x,
                       torch.sum(x * eng._dang), d=eng.d)
    for a, b in zip(got, _plain(eng, x)):
        assert torch.equal(a, b)
