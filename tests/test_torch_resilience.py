"""PyTorch port, the resilient live-serving path on the CPU, held to the JAX
package on the same inputs: ``validate_delta`` under every policy and
fault class; the ``FaultInjector``'s draws (the same operand, flat indices
and log on every tier and storage type, bf16 layouts included); the
watchdog verdicts and the ``ResilientRefresher`` ladder after each
injected fault; the resilient ``PageRankQueryEngine`` (the faulty-stream
example's script, stale / restored / degraded serves); JAX snapshots
restoring a port engine; the event log through the unchanged
``scripts/obs_report.py``; and faults of the card (a kernel that does not
build or launch, a CUDA error) propagating out of ``refresh``,
``recover`` and ``flush`` where an injected error becomes a status.

Tiers: ``dense``, ``ell``, ``fused_dense`` (JAX ``pallas_dense`` in
interpret mode) and ``bsr``, at n = 64 (``protein_network(64, seed=5)``,
as tests/test_resilience.py).  Ranks agree within rtol 1e-5 / atol 1e-7,
iteration counts within 1 (tests/test_obs.py)."""
import contextlib
import importlib.util
import io
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from repro.graph import delta as jdelta
from repro.graph import generators as jgen
from repro.graph import validate as jval
from repro.obs import registry as jreg
from repro.pagerank import DynamicPageRankEngine as JDyn
from repro.pagerank import PageRankEngine as JEngine
from repro.pagerank import resilience as jres
from repro.serve import PageRankQueryEngine as JQueryEngine
from repro.serve import ServeResilience as JServeResilience
from repro_torch.graph import delta as tdelta
from repro_torch.graph import validate as tval
from repro_torch.kernels._build import KernelBuildError, KernelLaunchError
from repro_torch.obs import registry as treg
from repro_torch.pagerank import DynamicPageRankEngine, PageRankEngine
from repro_torch.pagerank import dynamic as tdyn
from repro_torch.pagerank import engine as tengine
from repro_torch.pagerank import resilience as tres
from repro_torch.serve import PageRankQueryEngine, ServeResilience

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64
# port backend name -> JAX backend name
TIERS = {"dense": "dense", "ell": "ell", "fused_dense": "pallas_dense",
         "bsr": "bsr"}
PRECISIONS = ("f32", "bf16", "f16", "int8")
TOL_RANKS = dict(rtol=1e-5, atol=1e-7)
L1_BOUND = 1e-5
FIELDS = ("insert_src", "insert_dst", "delete_src", "delete_dst")
# the faulty-stream example's script
SCRIPT = [("delta", "out_of_range"), ("delta", "negative"),
          ("layout", "nan"), ("delta", "self_loop"), ("update", None),
          ("delta", "nan"), ("layout", "scale"), ("delta", "dup_flood")]

# one namespace per package, so a scenario is written once and run on both
JAX = types.SimpleNamespace(
    name="jax", Dyn=JDyn, Engine=JEngine, res=jres, delta=jdelta,
    val=jval, reg=jreg, QE=JQueryEngine, SR=JServeResilience, kw={},
    backend=lambda b: TIERS[b])
PORT = types.SimpleNamespace(
    name="port", Dyn=DynamicPageRankEngine, Engine=PageRankEngine, res=tres,
    delta=tdelta, val=tval, reg=treg, QE=PageRankQueryEngine,
    SR=ServeResilience, kw={"device": "cpu"}, backend=lambda b: b)


@pytest.fixture(scope="module")
def net():
    return jgen.protein_network(N, seed=5)


def _np(x) -> np.ndarray:
    """Host float copy of a port tensor or a JAX array (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _l1(a, b) -> float:
    return float(np.abs(_np(a).astype(np.float64)
                        - _np(b).astype(np.float64)).sum())


def _absent_pairs(src, dst, n, k, seed=0):
    """k undirected pairs not in the edge set (effective inserts)."""
    have = set(tdelta.edge_keys(src, dst, n).tolist())
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < k:
        u, v = (int(x) for x in rng.integers(0, n, size=2))
        if u != v and u * n + v not in have and (u, v) not in out:
            out.append((u, v))
    a = np.array(out, np.int64)
    return a[:, 0], a[:, 1]


def _dyn(pkg, net, backend, precision="f32", metrics=None, solve=True):
    src, dst = net
    eng = pkg.Dyn(src, dst, N, backend=pkg.backend(backend),
                  precision=precision,
                  metrics=metrics or pkg.reg.NullRegistry(), **pkg.kw)
    if solve:
        eng.run_tol(1e-7, max_iters=500)
    return eng


def _scratch(src, dst, n=N):
    return PageRankEngine(src, dst, n, backend="dense", device="cpu",
                          metrics=treg.NullRegistry()).run_tol(
        1e-8, max_iters=1000)[0]


def _same_delta(t, j):
    for f in FIELDS:
        a, b = np.asarray(getattr(t, f)), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.timestamp == j.timestamp


def _layout_leaf(op):
    return getattr(op, "blocks", op)


# --------------------------------------------------------------------- #
# validate_delta: quarantine / reject / clip                            #
# --------------------------------------------------------------------- #
def _validate(val, delta, policy):
    try:
        return val.validate_delta(delta, N, policy), None
    except val.DeltaRejected as e:
        return None, e


@pytest.mark.parametrize("policy", ["quarantine", "reject", "clip"])
@pytest.mark.parametrize("kind", ["out_of_range", "negative", "self_loop",
                                  "nan", "dup_flood", "oversized", "clean"])
def test_validate_delta_matches_jax(kind, policy):
    """The same delta under the same policy: the same surviving edges, the
    same dead letters in the same order (reason, side, raw endpoints),
    the same counts, and ``DeltaRejected`` in the same cases."""
    if kind == "clean":
        t_in = tdelta.GraphDelta.inserts([1, 2], [3, 4])
        j_in = jdelta.GraphDelta.inserts([1, 2], [3, 4])
    else:
        tinj, jinj = tres.FaultInjector(seed=7), jres.FaultInjector(seed=7)
        t_in, j_in = tinj.corrupt_delta(N, kind), jinj.corrupt_delta(N, kind)
        assert tinj.log == jinj.log
        _same_delta(t_in, j_in)
    # the oversized class names 256 edges: a budget of 64 truncates it
    kw = {"max_batch_edges": 64} if kind == "oversized" else {}
    tr, terr = _validate(tval, t_in, tval.ValidationPolicy(policy, **kw))
    jr, jerr = _validate(jval, j_in, jval.ValidationPolicy(policy, **kw))
    assert (terr is None) == (jerr is None)
    if terr is not None:
        assert (terr.reasons, terr.n_bad, str(terr)) == (
            jerr.reasons, jerr.n_bad, str(jerr))
        return
    assert (tr.n_accepted, tr.n_dropped, tr.reasons, tr.clean) == (
        jr.n_accepted, jr.n_dropped, jr.reasons, jr.clean)
    assert (tr.delta is None) == (jr.delta is None)
    if tr.delta is not None:
        _same_delta(tr.delta, jr.delta)
    assert len(tr.dead_letters) == len(jr.dead_letters)
    for a, b in zip(tr.dead_letters, jr.dead_letters):
        assert (a.reason, a.side, a.timestamp, a.n_edges) == (
            b.reason, b.side, b.timestamp, b.n_edges)
        for x, y in ((a.src, b.src), (a.dst, b.dst)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    tq, jq = tval.DeadLetterQueue(maxlen=4), jval.DeadLetterQueue(maxlen=4)
    tq.extend(tr.dead_letters)
    jq.extend(jr.dead_letters)
    assert (tq.counts(), len(tq), tq.total_seen) == (
        jq.counts(), len(jq), jq.total_seen)


def test_validation_policy_and_queue_like_jax():
    with pytest.raises(ValueError, match="quarantine|reject|clip"):
        tval.ValidationPolicy(on_invalid="drop")
    assert tval.ValidationPolicy() == tval.ValidationPolicy(
        **{f: getattr(jval.ValidationPolicy(), f) for f in (
            "on_invalid", "max_batch_edges", "max_duplicate_ratio",
            "allow_self_loops")})
    q = tval.DeadLetterQueue(maxlen=4)
    inj = tres.FaultInjector(seed=11)
    for _ in range(6):
        q.extend(tval.validate_delta(inj.corrupt_delta(N, "self_loop"),
                                     N).dead_letters)
    assert len(q) == 4 and q.total_seen == 6
    assert set(q.counts()) == {"self_loop"}


# --------------------------------------------------------------------- #
# the injector's draws                                                  #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def engine_pairs(net):
    """(JAX, port) dynamic engines per (tier, storage type), unsolved;
    each injector test puts the operands back."""
    cache = {}

    def get(backend, precision):
        if (backend, precision) not in cache:
            cache[backend, precision] = (
                _dyn(JAX, net, backend, precision, solve=False),
                _dyn(PORT, net, backend, precision, solve=False))
        return cache[backend, precision]
    return get


def _poison(inj, eng, kind):
    try:
        inj.corrupt_layout(eng, kind=kind)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kind", ["nan", "inf", "huge", "scale"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("backend", list(TIERS))
def test_corrupt_layout_matches_jax(engine_pairs, backend, precision, kind):
    """The same seed poisons the same operand at the same flat indices:
    equal logs, equal poisoned tensors (NaN and Inf positions included).
    "Float" is numpy's floating, so a bf16 layout is skipped over: the
    fused tier's bf16 ``Hp`` leaves ``dangp`` (operand 1) to be poisoned,
    and a tier with no other float operand raises in both packages."""
    j, t = engine_pairs(backend, precision)
    j_ops, t_ops = j._operands, t._operands
    jinj, tinj = jres.FaultInjector(seed=11), tres.FaultInjector(seed=11)
    try:
        jerr, terr = _poison(jinj, j, kind), _poison(tinj, t, kind)
        assert terr == jerr and tinj.log == jinj.log
        if jerr is not None:
            assert precision in ("bf16", "int8")
            return
        target = int(jinj.log[-1].split("operand=")[1].rstrip(")"))
        if backend == "fused_dense" and precision == "bf16":
            assert target == 1
        ja = _np(_layout_leaf(j._operands[target]))
        ta_dev = _layout_leaf(t._operands[target])
        assert ta_dev.dtype == _layout_leaf(t_ops[target]).dtype
        assert ta_dev.device.type == "cpu"
        ta = _np(ta_dev)
        np.testing.assert_array_equal(np.isfinite(ta), np.isfinite(ja))
        np.testing.assert_array_equal(ta, ja)
        if kind != "scale":
            assert (~np.isfinite(ta)).sum() == (4 if kind != "huge" else 0)
        for i, op in enumerate(t._operands):
            if i != target:
                assert op is t_ops[i]
    finally:
        j._operands, t._operands = j_ops, t_ops


@pytest.mark.parametrize("kind", ["nan", "inf", "negative"])
def test_corrupt_ranks_matches_jax(net, kind):
    j, t = _dyn(JAX, net, "ell"), _dyn(PORT, net, "ell")
    jinj, tinj = jres.FaultInjector(seed=3), tres.FaultInjector(seed=3)
    jinj.corrupt_ranks(j, kind=kind)
    tinj.corrupt_ranks(t, kind=kind)
    assert tinj.log == jinj.log
    assert t.ranks.dtype == torch.float32 and t.ranks.device.type == "cpu"
    np.testing.assert_array_equal(np.isfinite(_np(t.ranks)),
                                  np.isfinite(_np(j.ranks)))
    assert not tres.ranks_healthy(t.ranks)
    assert not jres.ranks_healthy(j.ranks)


# --------------------------------------------------------------------- #
# the watchdog and the ladder                                           #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["nan", "inf", "huge", "scale"])
@pytest.mark.parametrize("backend", list(TIERS))
def test_watchdog_verdict_matches_jax(net, backend, kind):
    """A poisoned layout ends ``run_tol`` with the JAX verdict, within one
    iteration of the JAX exit, before ``max_iters`` (NaN, Inf and a scaled
    operator early; 1e4 entries take as long to overflow as in JAX)."""
    out = []
    for pkg in (JAX, PORT):
        eng = _dyn(pkg, net, backend, solve=False)
        pkg.res.FaultInjector(seed=3).corrupt_layout(eng, kind=kind)
        out.append(eng.run_tol(tol=1e-7, max_iters=500))
    ji, (tpr, _, _) = out[0].info, out[1]
    ti = out[1].info
    assert ti.status == ji.status
    assert abs(ti.iters - ji.iters) <= 1
    assert ti.failed
    assert ti.iters < (50 if kind != "huge" else 500)
    assert not tres.ranks_healthy(tpr)


def _ladder(pkg, net, backend, scenario):
    """Run one injected fault through a ResilientRefresher: returns the
    engine, the outcomes, the refresher and the delta."""
    src, dst = net
    eng = _dyn(pkg, net, backend)
    ref = pkg.res.ResilientRefresher(retry=pkg.res.RetryPolicy(
        max_retries=2))
    assert ref.baseline(eng) is not None
    inj = pkg.res.FaultInjector(seed=5)
    iu, iv = _absent_pairs(src, dst, N, 1, seed=6)
    delta = pkg.delta.GraphDelta.inserts(iu, iv)
    if scenario in ("nan", "inf", "scale"):
        inj.corrupt_layout(eng, kind=scenario)
    elif scenario == "fail_once":
        inj.fail_next_updates(eng, times=1)
    elif scenario == "fail_all":
        inj.fail_next_updates(eng, times=5)     # > 3 attempts
    elif scenario == "rebuild_fails":
        inj.corrupt_layout(eng, kind="nan")

        def failing_rebuild(*a, **kw):
            raise RuntimeError("injected rebuild failure")
        eng.rebuild_and_solve = failing_rebuild
    outcomes = [ref.refresh(eng, delta, tol=1e-7, max_iters=500)]
    if scenario == "fail_all":
        # the next refresh burns the 2 faults left in its retries
        outcomes.append(ref.refresh(eng, delta, tol=1e-7, max_iters=500))
    return eng, outcomes, ref, inj


LADDER = {"nan": ["recovered"], "inf": ["recovered"],
          "scale": ["recovered"], "fail_once": ["ok"],
          "fail_all": ["failed", "ok"], "rebuild_fails": ["restored"]}


@pytest.mark.parametrize("scenario", list(LADDER))
@pytest.mark.parametrize("backend", list(TIERS))
def test_refresher_ladder_matches_jax(net, backend, scenario):
    """Every rung of tests/test_resilience.py's ladder: ``recovered`` after
    a NaN / Inf / scaled layout, ``ok`` after 2 attempts, ``failed`` when
    every attempt raises (then ``ok`` after 3), ``restored`` when the
    rebuild fails — with the JAX refresher's outcome, watchdog verdict and
    ranks."""
    src, dst = net
    je, jouts, jref, jinj = _ladder(JAX, net, backend, scenario)
    te, touts, tref, tinj = _ladder(PORT, net, backend, scenario)
    assert tinj.log == jinj.log
    assert [o.status for o in touts] == [o.status for o in jouts] \
        == LADDER[scenario]
    for to, jo in zip(touts, jouts):
        assert (to.attempts, to.delta_applied) == (jo.attempts,
                                                   jo.delta_applied)
        assert (to.error is None) == (jo.error is None)
        if jo.error is not None:
            assert "injected" in to.error
            assert to.error == jo.error
        assert (to.update_info is None) == (jo.update_info is None)
        if jo.update_info is not None:
            ti, ji = to.update_info, jo.update_info
            assert (ti.strategy, ti.diverged, ti.nonfinite, ti.healthy,
                    ti.n_inserted) == (ji.strategy, ji.diverged,
                                       ji.nonfinite, ji.healthy,
                                       ji.n_inserted)
            assert abs(ti.iters - ji.iters) <= 1
    assert te.last_solve_info.status == je.last_solve_info.status
    assert abs(te.last_solve_info.iters - je.last_solve_info.iters) <= 1
    assert (tref.store.version, len(tref.store)) == (jref.store.version,
                                                     len(jref.store))
    assert te.n_edges == je.n_edges
    np.testing.assert_allclose(_np(te.ranks), _np(je.ranks), **TOL_RANKS)
    assert tres.ranks_healthy(te.ranks)
    if touts[-1].delta_applied:
        d = tdelta.GraphDelta.inserts(*_absent_pairs(src, dst, N, 1, seed=6))
        assert _l1(te.ranks, _scratch(*tdelta.apply_delta(src, dst, d, N))) \
            <= L1_BOUND
    else:
        assert _l1(te.ranks, tref.store.latest().ranks) == 0.0


def test_retry_policy_and_rank_store_like_jax(net):
    for kw in ({}, {"max_retries": 3, "base_delay_s": 0.5},
               {"max_retries": 0}):
        assert list(tres.RetryPolicy(**kw).delays()) == list(
            jres.RetryPolicy(**kw).delays())
    dyn = _dyn(PORT, net, "dense")
    store = tres.RankStore(maxlen=2)
    for _ in range(5):
        store.record(dyn)
    assert len(store) == 2 and store.latest().version == 5
    assert isinstance(store.latest().ranks, np.ndarray)
    assert tres.ranks_healthy(store.latest().ranks)


@pytest.mark.parametrize("backend", list(TIERS))
def test_jax_snapshot_restores_a_port_engine(net, backend):
    """A JAX ``RankStore`` snapshot (numpy keys and ranks) restores a port
    engine built on another graph: the same edge set and ranks, the JAX
    layout, and then the JAX ``run_tol``."""
    src, dst = net
    j = _dyn(JAX, net, backend)
    iu, iv = _absent_pairs(src, dst, N, 3, seed=2)
    j.update(jdelta.GraphDelta(iu, iv, src[:2], dst[:2]))
    snap = jres.RankStore().record(j)
    t = _dyn(PORT, net, backend, solve=False)
    t.restore(snap)
    assert t.n_edges == j.n_edges and np.array_equal(t._keys, j._keys)
    np.testing.assert_array_equal(_np(t.ranks), np.asarray(snap.ranks))
    jr = j.run_tol(1e-7, max_iters=500)
    tr = t.run_tol(1e-7, max_iters=500)
    assert tr.info.status == jr.info.status == "converged"
    assert abs(tr.info.iters - jr.info.iters) <= 1
    np.testing.assert_allclose(_np(tr[0]), _np(jr[0]), **TOL_RANKS)


# --------------------------------------------------------------------- #
# the resilient serve path                                              #
# --------------------------------------------------------------------- #
def _faulty_stream(pkg, backend, n=N, seed=0):
    """The faulty-stream example's 8 steps; returns what each step served,
    the dead letters, the injector log, the final ranks and their L1
    against a from-scratch engine on the accepted edges."""
    stream = pkg.delta.EdgeStream(n, m_edges=4, seed=seed,
                                  insert_per_step=4, delete_per_step=0)
    src, dst = stream.base()
    cur = (src, dst)
    engine = pkg.Dyn(src, dst, n, backend=pkg.backend(backend),
                     metrics=pkg.reg.NullRegistry(), **pkg.kw)
    engine.run_tol(1e-7)
    serve = pkg.QE(engine, n_iters=60, max_batch=4, resilience=pkg.SR())
    inj = pkg.res.FaultInjector(seed=seed)
    rng = np.random.default_rng(seed)
    steps = []
    for step, (klass, kind) in enumerate(SCRIPT):
        good = stream.step()
        serve.push_update(good)
        cur = pkg.delta.apply_delta(cur[0], cur[1], good, n)
        if klass == "delta":
            res = serve.push_update(inj.corrupt_delta(n, kind=kind))
            if res.delta is not None:
                cur = pkg.delta.apply_delta(cur[0], cur[1], res.delta, n)
        elif klass == "layout":
            inj.corrupt_layout(engine, kind=kind)
        else:
            inj.fail_next_updates(engine, times=1)
        queries = [serve.submit(uid=step * 10 + q,
                                seeds=rng.choice(n, size=3, replace=False),
                                top_k=5) for q in range(2)]
        serve.flush()
        o = serve.last_refresh_outcome
        steps.append((o.status, o.attempts, o.delta_applied,
                      [(q.status, q.graph_version,
                        np.asarray(q.result[0]).tolist()) for q in queries]))
        for q in queries:
            assert np.isfinite(np.asarray(q.result[1])).all()
    ref = pkg.Engine(cur[0], cur[1], n, backend="ell", **pkg.kw).run_tol(
        1e-7, max_iters=1000)[0]
    return (steps, serve.dead_letters.counts(), inj.log,
            _np(engine.ranks), _l1(engine.ranks, ref))


@pytest.mark.parametrize("backend", ["ell", "fused_dense"])
def test_faulty_stream_script_matches_jax(backend):
    jsteps, jdead, jlog, jranks, jl1 = _faulty_stream(JAX, backend)
    tsteps, tdead, tlog, tranks, tl1 = _faulty_stream(PORT, backend)
    assert tsteps == jsteps
    assert [s[0] for s in tsteps] == ["ok", "ok", "recovered", "ok", "ok",
                                      "ok", "recovered", "ok"]
    assert tsteps[4][1] == 2
    assert all(q[0] == "fresh" for s in tsteps for q in s[3])
    assert tdead == jdead and tlog == jlog
    np.testing.assert_allclose(tranks, jranks, **TOL_RANKS)
    assert tl1 <= L1_BOUND and jl1 <= L1_BOUND
    assert abs(tl1 - jl1) <= 1e-6


def _serve_scenario(pkg, net, scenario, monkeypatch):
    """One resilient serve scenario of tests/test_resilience.py; returns
    the statuses, versions and top-k of each flush, and the outcomes."""
    src, dst = net
    static = scenario == "degraded_static"
    if static:
        eng = pkg.Engine(src, dst, N, backend="ell",
                         metrics=pkg.reg.NullRegistry(), **pkg.kw)
    else:
        eng = _dyn(pkg, net, "ell")
    qe = pkg.QE(eng, n_iters=50, max_batch=8, resilience=pkg.SR())
    inj = pkg.res.FaultInjector(seed=21)
    iu, iv = _absent_pairs(src, dst, N, 1, seed=10)
    rng = np.random.default_rng(4)
    seeds = [rng.choice(N, size=2, replace=False) for _ in range(3)]
    flushes = []

    def flush():
        qs = [qe.submit(uid, s, top_k=5) for uid, s in enumerate(seeds)]
        qe.flush()
        o = qe.last_refresh_outcome
        flushes.append((None if o is None else (o.status, o.attempts),
                        [(q.status, q.graph_version,
                          np.asarray(q.result[0]).tolist(),
                          np.asarray(q.result[1])) for q in qs]))

    if scenario == "stale_then_fresh":
        qe.push_update(pkg.delta.GraphDelta.inserts(iu, iv))
        inj.fail_next_updates(eng, times=5)
        flush()
        flush()                      # the re-queued delta lands
    elif scenario == "poisoned_batch":
        inj.corrupt_layout(eng, kind="nan")
        flush()
    elif scenario == "restored":
        qe.push_update(pkg.delta.GraphDelta.inserts(iu, iv))
        inj.corrupt_layout(eng, kind="nan")
        inner = eng.rebuild_and_solve

        def failing_once(*a, **kw):
            eng.rebuild_and_solve = inner
            raise RuntimeError("injected rebuild failure")
        eng.rebuild_and_solve = failing_once
        flush()
        flush()
    elif scenario == "degraded_static":
        inj.corrupt_layout(eng, kind="nan")
        flush()
    elif scenario == "degraded_snapshot":
        def raising(*a, **k):
            raise RuntimeError("injected")
        monkeypatch.setattr(eng, "ppr", raising)
        monkeypatch.setattr(qe.refresher, "recover", lambda *a, **k: None)
        flush()
        snap = qe.refresher.store.latest()
        flushes.append(np.argsort(-np.asarray(snap.ranks),
                                  kind="stable")[:5].tolist())
    return flushes


SERVE = {"stale_then_fresh": [["stale"] * 3, ["fresh"] * 3],
         "poisoned_batch": [["fresh"] * 3],
         "restored": [["stale"] * 3, ["fresh"] * 3],
         "degraded_static": [["degraded"] * 3],
         "degraded_snapshot": [["degraded"] * 3]}


@pytest.mark.parametrize("scenario", list(SERVE))
def test_serve_scenarios_match_jax(net, scenario, monkeypatch):
    """stale on a failed refresh then fresh once the re-queued delta
    lands; a poisoned batch recovered in one flush; a rebuild that fails
    once restores the snapshot (stale) and the next refresh is fresh; a
    static engine degrades to uniform global ranks; a failing serve with
    recovery out of the way degrades to the last snapshot's ranks."""
    jf = _serve_scenario(JAX, net, scenario, monkeypatch)
    tf = _serve_scenario(PORT, net, scenario, monkeypatch)
    want = SERVE[scenario]
    for k, statuses in enumerate(want):
        (jo, jq), (to, tq) = jf[k], tf[k]
        assert to == jo
        assert [q[0] for q in tq] == [q[0] for q in jq] == statuses
        assert [q[1] for q in tq] == [q[1] for q in jq]
        if scenario == "degraded_static":
            # uniform ranks: every index ties, and torch.topk and
            # lax.top_k order ties differently
            assert all(np.all(q[3] == np.float32(1.0 / N)) for q in tq)
        else:
            assert [q[2] for q in tq] == [q[2] for q in jq]
        for a, b in zip(tq, jq):
            np.testing.assert_allclose(a[3], b[3], rtol=1e-4, atol=1e-6)
            assert np.isfinite(a[3]).all() and (a[3] >= 0).all()
    if scenario == "degraded_snapshot":
        assert all(q[2] == tf[-1] for q in tf[0][1])
    if scenario == "restored":
        assert tf[0][0] == ("restored", 1) and tf[1][0] == ("ok", 1)


def test_serve_reject_policy_still_raises(net):
    eng = _dyn(PORT, net, "ell")
    qe = PageRankQueryEngine(eng, resilience=ServeResilience(
        validation=tval.ValidationPolicy(on_invalid="reject")))
    with pytest.raises(tval.DeltaRejected):
        qe.push_update(tres.FaultInjector(seed=24).corrupt_delta(
            N, "negative"))
    assert not qe._pending_deltas


def test_noisy_stream_serves_through_every_fault_class(net):
    """tests/test_resilience.py's noisy stream on the port: every fault
    class interleaved with valid ticks, served without a raise, ending in
    parity with a clean engine on the accepted edges."""
    stream = tdelta.EdgeStream(N, m_edges=3, seed=4, insert_per_step=3,
                               delete_per_step=0)
    cur = stream.base()
    dyn = DynamicPageRankEngine(cur[0], cur[1], N, backend="ell",
                                device="cpu", metrics=treg.NullRegistry())
    dyn.run_tol(1e-7, max_iters=500)
    qe = PageRankQueryEngine(dyn, n_iters=50, max_batch=8,
                             resilience=ServeResilience())
    inj = tres.FaultInjector(seed=25)
    faults = ["out_of_range", "negative", "self_loop", "nan", "dup_flood"]
    rng = np.random.default_rng(0)
    for step, kind in enumerate(faults):
        res = qe.push_update(inj.corrupt_delta(N, kind=kind))
        assert not res.clean
        if res.delta is not None:
            cur = tdelta.apply_delta(cur[0], cur[1], res.delta, N)
        good = stream.step()
        qe.push_update(good)
        cur = tdelta.apply_delta(cur[0], cur[1], good, N)
        if kind == "nan":
            inj.corrupt_layout(dyn, kind="scale")
        if kind == "self_loop":
            inj.fail_next_updates(dyn, times=1)
        seeds = [rng.choice(N, size=2, replace=False) for _ in range(3)]
        for q in qe.query_batch(seeds, top_k=5):
            assert np.isfinite(q[1]).all()
    assert qe.dead_letters.total_seen >= len(faults)
    assert set(qe.dead_letters.counts()) >= {
        "out_of_range", "negative_id", "self_loop", "nonfinite",
        "duplicate_flood"}
    assert tres.ranks_healthy(dyn.ranks)
    assert _l1(dyn.ranks, _scratch(cur[0], cur[1])) <= L1_BOUND
    assert tres.ppr_healthy(dyn.ppr([[1, 2], [3]], n_iters=50))


# --------------------------------------------------------------------- #
# observability: the port's log through scripts/obs_report.py           #
# --------------------------------------------------------------------- #
def _obs_report():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import obs_report
    finally:
        sys.path.pop(0)
    return obs_report


def test_serve_report_roundtrip_exact(net, tmp_path, monkeypatch):
    """tests/test_obs.py's acceptance bar on the port: the JSONL alone
    reproduces the fresh/stale/degraded counts, the refresh outcomes, the
    dead letters and the serve-latency quantiles of the registry."""
    obs_report = _obs_report()
    n = 48
    src, dst = jgen.protein_network(n, seed=0)
    jsonl = str(tmp_path / "events.jsonl")
    reg = treg.MetricsRegistry(jsonl_path=jsonl)
    eng = DynamicPageRankEngine(src, dst, n, backend="ell", device="cpu",
                                metrics=reg)
    eng.run_tol(1e-6)
    server = PageRankQueryEngine(eng, n_iters=20, max_batch=10_000,
                                 resilience=ServeResilience(), metrics=reg)
    rng = np.random.default_rng(3)
    server.push_update(tdelta.GraphDelta.inserts(rng.integers(0, n, 3),
                                                 rng.integers(0, n, 3)))
    for uid in range(3):
        server.submit(uid, rng.integers(0, n, 2))
    server.flush()
    server.push_update(tdelta.GraphDelta.inserts([0, n + 1], [n + 2, 1]))

    def raising(*a, **k):
        raise RuntimeError("injected")
    monkeypatch.setattr(eng, "ppr", raising)
    monkeypatch.setattr(server.refresher, "recover", lambda *a, **k: None)
    for uid in range(2):
        server.submit(uid, rng.integers(0, n, 2))
    out = server.flush()
    assert [q.status for q in out] == ["degraded", "degraded"]
    reg.dump_json(str(tmp_path / "metrics.json"))
    reg.close()
    derived = obs_report.derive(obs_report.load_events(jsonl))
    assert derived["queries"] == {"fresh": 3, "degraded": 2}
    assert derived["refreshes"].get("ok", 0) >= 1
    assert derived["dead_letters"] == 2
    metrics = json.load(open(tmp_path / "metrics.json"))
    assert obs_report.cross_check(derived, metrics) == []
    assert obs_report.main([jsonl, "--metrics",
                            str(tmp_path / "metrics.json")]) == 0


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue().splitlines()


def test_faulty_stream_example_prints_the_jax_example(tmp_path):
    """The port's example on the CPU prints the JAX example's statuses,
    versions, dead letters and injector log (all but the L1 figure), exits
    0, and its event log re-derives exactly through obs_report."""
    jrc, jout = _run_example(_load_example("faulty_stream_pagerank"),
                             ["--nodes", str(N)])
    jsonl, mjson = str(tmp_path / "ev.jsonl"), str(tmp_path / "m.json")
    trc, tout = _run_example(
        _load_example("torch_faulty_stream_pagerank"),
        ["--nodes", str(N), "--device", "cpu", "--jsonl", jsonl,
         "--metrics-out", mjson])
    assert trc == jrc == 0
    assert [ln for ln in tout if "L1(" not in ln] == [
        ln for ln in jout if "L1(" not in ln]
    assert sum("status=fresh" in ln for ln in tout) == len(SCRIPT)
    obs_report = _obs_report()
    derived = obs_report.derive(obs_report.load_events(jsonl))
    assert derived["queries"] == {"fresh": 2 * len(SCRIPT)}
    assert derived["refreshes"] == {"ok": 6, "recovered": 2}
    assert obs_report.main([jsonl, "--metrics", mjson]) == 0


# --------------------------------------------------------------------- #
# faults of the card propagate                                          #
# --------------------------------------------------------------------- #
CARD_FAULTS = {
    "build": lambda: KernelBuildError("nvcc failed for streaming_matvec.cu"),
    "launch": lambda: KernelLaunchError(
        "streaming_matvec launch failed: cudaError_t 700"),
    "cuda_error": lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
    "accelerator": lambda: getattr(torch, "AcceleratorError", RuntimeError)(
        "CUDA error: unspecified launch failure"),
    "injected": lambda: RuntimeError("injected kernel failure"),
}


def _entry(pkg, eng, qe, entry):
    if entry == "refresh":
        qe.push_update(pkg.delta.GraphDelta.inserts([1], [40]))
        return qe.refresh()[0].status
    if entry == "recover":
        return qe.refresher.recover(eng, tol=1e-7).status
    qs = [qe.submit(uid, s) for uid, s in enumerate([[1, 2], [3]])]
    qe.flush()
    return [q.status for q in qs]


@pytest.mark.parametrize("entry", ["refresh", "recover", "flush"])
@pytest.mark.parametrize("fault", list(CARD_FAULTS))
def test_card_faults_propagate(net, monkeypatch, fault, entry):
    """With every kernel wrapper of the fused tier raising: a build or
    launch failure and a CUDA error propagate out of ``refresh``,
    ``recover`` and ``flush`` (the deltas stay queued); an injected error
    becomes the status the JAX package gives when the same calls raise."""
    eng = _dyn(PORT, net, "fused_dense")
    qe = PageRankQueryEngine(eng, n_iters=20, resilience=ServeResilience())

    def boom(*a, **k):
        raise CARD_FAULTS[fault]()
    for mod, name in ((tengine, "pagerank_step_fused"),
                      (tengine, "streaming_matvec"),
                      (tdyn, "streaming_matvec")):
        monkeypatch.setattr(mod, name, boom)
    if fault != "injected":
        exc = CARD_FAULTS[fault]()
        assert tres.is_kernel_fault(exc)
        with pytest.raises(type(exc), match=str(exc)[:12]):
            _entry(PORT, eng, qe, entry)
        if entry == "refresh":
            assert len(qe._pending_deltas) == 1
        return
    assert not tres.is_kernel_fault(CARD_FAULTS[fault]())
    got = _entry(PORT, eng, qe, entry)
    # the JAX engine with the same calls raising the same error
    jeng = _dyn(JAX, net, "fused_dense")
    jqe = JQueryEngine(jeng, n_iters=20, resilience=JServeResilience())
    for name in ("update", "rebuild_and_solve", "ppr"):
        monkeypatch.setattr(jeng, name, boom)
    want = _entry(JAX, jeng, jqe, entry)
    assert got == want
    assert want in ("failed", "restored") or set(want) == {"degraded"}


def test_watchdog_init_runs_on_the_card_unless_asked(monkeypatch):
    """No public function of the port defaults to the CPU: the watchdog
    carry goes on the card, raises without CUDA, and lands on the CPU only
    when the caller names it (as the JAX carry starts at 0 and True)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tres.watchdog_init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tres.watchdog_init("cuda")
    grow, ok = tres.watchdog_init("cpu")
    assert grow.device.type == ok.device.type == "cpu"
    assert grow.dtype == torch.int32 and int(grow) == 0
    assert ok.dtype == torch.bool and bool(ok)
