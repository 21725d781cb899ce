"""The port's checkpoints, fault policies and data pipeline against the
JAX package's: the cases of ``tests/test_checkpoint_fault.py`` and the
data cases of ``tests/test_sharding_data.py`` through both packages, a
checkpoint written by either restored by the other (train states, a
bfloat16 leaf, a bfloat16 model), the manifest's leaf names equal to
JAX's key paths, and the crash / resume cycle bit-equal to an
uninterrupted run."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.train import checkpoint as jckpt
from repro.train import fault as jfault
from repro.train import make_train_state as jmake_state
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable_shapes,
                                 get_config, get_smoke_config)
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import (DataIterator, batch_shapes,
                                       input_specs, make_batch)
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train import (OptimizerConfig, checkpoint as ckpt,
                               init_opt_state, make_train_state, train_step)
from repro_torch.train.fault import (PreemptionGuard, StragglerPolicy,
                                     assign_shards, reassign_on_failure,
                                     run_with_restarts)

from lm_parity import one_torch_thread  # noqa: F401

SHAPE = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
ARCH = "internlm2-1.8b"


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_tree():
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((3, 4)).astype(np.float32)
    return ({"a": torch.arange(10, dtype=torch.float32),
             "b": {"c": torch.from_numpy(vals).to(torch.bfloat16)}},
            {"a": jnp.arange(10, dtype=jnp.float32),
             "b": {"c": jnp.asarray(vals).astype(jnp.bfloat16)}})


def jax_state(arch=ARCH, compression="int8_ef", key=0):
    cfg = jget(arch)
    return cfg, *jmake_state(cfg, jax.random.PRNGKey(key), compression)


def port_state_like(jp, compression="int8_ef", arch=ARCH):
    """The port's train state holding the JAX state's parameters."""
    tp = params_from_numpy(get_smoke_config(arch),
                           jax.tree.map(np.asarray, jp), device="cpu",
                           trainable=True)
    return tp, init_opt_state(tp, compression)


# ------------------------------------------------------- checkpoints --- #
def test_save_restore_roundtrip(tmp_path):
    tree, _ = _bf16_tree()
    ckpt.save(str(tmp_path), 7, tree, extra={"data_step": 42})
    restored, step, extra = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert step == 7 and extra["data_step"] == 42
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_bf16_leaf_in_both_directions(tmp_path):
    """A bfloat16 leaf is stored as its uint16 bits with "bfloat16" in the
    manifest by both packages, and restores bit for bit in the other."""
    tree, jtree = _bf16_tree()
    ckpt.save(str(tmp_path / "port"), 1, tree)
    jckpt.save(str(tmp_path / "jax"), 1, jtree)
    for d in ("port", "jax"):
        with open(tmp_path / d / "step_00000001" / "manifest.json") as f:
            m = json.load(f)
        assert m["names"] == ["['a']", "['b']/['c']"]
        assert m["dtypes"] == ["float32", "bfloat16"]
        assert m["shapes"] == [[10], [3, 4]]
        with np.load(tmp_path / d / "step_00000001" /
                     "arrays_00000.npz") as z:
            assert z["1"].dtype == np.uint16
    jr, _, _ = jckpt.restore(str(tmp_path / "port"), jtree)
    assert jr["b"]["c"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(jr["b"]["c"]),
                                  tree["b"]["c"].float().numpy())
    tr, _, _ = ckpt.restore(str(tmp_path / "jax"), tree, device="cpu")
    assert tr["b"]["c"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tr["b"]["c"].float().numpy(),
                                  _f32(jtree["b"]["c"]))
    np.testing.assert_array_equal(tr["a"].numpy(), np.arange(10))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_latest_and_gc(tmp_path, writer):
    save = ckpt.save if writer == "port" else jckpt.save
    tree = ({"x": torch.zeros(2)} if writer == "port"
            else {"x": jnp.zeros((2,))})
    for s in [1, 5, 3]:
        save(str(tmp_path), s, tree)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.list_steps(str(tmp_path)) == jckpt.list_steps(
        str(tmp_path)) == [1, 3, 5]
    ckpt.garbage_collect(str(tmp_path), keep_last=1)
    assert ckpt.list_steps(str(tmp_path)) == [5]
    assert jckpt.latest_step(str(tmp_path)) == 5


def test_crashed_writer_is_ignored(tmp_path):
    """A checkpoint dir without COMMITTED (a mid-write crash) is
    invisible to restore in both packages; orphan tmp dirs are GC'd."""
    tree = {"x": torch.arange(4, dtype=torch.float32)}
    ckpt.save(str(tmp_path), 1, tree)
    crash = tmp_path / "step_00000002"
    crash.mkdir()
    (crash / "manifest.json").write_text("{}")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert jckpt.latest_step(str(tmp_path)) == 1
    restored, step, _ = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert step == 1 and torch.equal(restored["x"], tree["x"])
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), tree, step=2, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree, device="cpu")
    (tmp_path / "step_00000009.tmp").mkdir()
    ckpt.garbage_collect(str(tmp_path), keep_last=3)
    assert not (tmp_path / "step_00000009.tmp").exists()


def test_structure_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"b": torch.zeros(2)}, device="cpu")
    with pytest.raises(ValueError):
        jckpt.restore(str(tmp_path), {"b": jnp.zeros((2,))})
    # a model of another width has the same names: the shapes catch it
    cfg = get_smoke_config(ARCH)
    ckpt.save(str(tmp_path), 2, TM.init_params(cfg, 0, device="cpu"))
    wider = dataclasses.replace(cfg, d_model=2 * cfg.d_model)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), TM.init_params(wider, 0, device="cpu"),
                     device="cpu")


@pytest.mark.parametrize("compression", ["int8_ef", "none"])
def test_manifest_names_are_jax_key_paths(tmp_path, compression):
    """The port's train state saves under JAX's key-path strings, in
    JAX's order, with JAX's stacked shapes and dtypes."""
    _, jp, jo = jax_state(compression=compression)
    tp, to = port_state_like(jp, compression)
    ckpt.save(str(tmp_path), 3, {"params": tp, "opt": to})
    names, leaves, _ = jckpt._tree_paths({"params": jp, "opt": jo})
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        m = json.load(f)
    assert m["names"] == names
    assert m["shapes"] == [list(x.shape) for x in leaves]
    assert m["dtypes"] == [str(np.asarray(x).dtype) for x in leaves]
    assert "['opt']/.m/['embed']/['table']" in names
    assert "['params']/['layers']/['attn']/['wk']" in names
    assert names[0] == "['opt']/.step"
    assert any(".ef/" in n for n in names) == (compression != "none")


def test_train_state_jax_to_port(tmp_path):
    """A JAX train state after two steps restores into the port bit for
    bit (parameters, moments, residual, step) and trains on."""
    from repro.train import OptimizerConfig as JOpt
    from repro.train import train_step as jtrain_step
    jcfg, jp, jo = jax_state()
    ocfg = JOpt(warmup_steps=1, total_steps=10, compression="int8_ef")
    for s in range(2):
        jp, jo, _ = jtrain_step(jp, jo, jpipe.make_batch(jcfg, JShape(
            "t", 16, 4, "train"), step=s), jcfg, ocfg)
    jckpt.save(str(tmp_path), 2, {"params": jp, "opt": jo},
               extra={"data": {"step": 2}})
    like = dict(zip(("params", "opt"), make_train_state(
        get_smoke_config(ARCH), 9, device="cpu")))
    tree, step, extra = ckpt.restore(str(tmp_path), like, device="cpu")
    assert step == 2 and extra == {"data": {"step": 2}}
    tp, to = tree["params"], tree["opt"]
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in tp.parameters())
    assert int(to.step) == 2 and to.step.dtype == torch.int32
    for t, j in ((tp, jp), (to.m, jo.m), (to.v, jo.v), (to.ef, jo.ef)):
        for a, b in zip(jax.tree.leaves(params_to_numpy(t)),
                        jax.tree.leaves(j), strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))
    _, _, m = train_step(tp, to, make_batch(
        get_smoke_config(ARCH), SHAPE, step=2, device="cpu"),
        get_smoke_config(ARCH), OptimizerConfig(warmup_steps=1,
                                                total_steps=10))
    assert np.isfinite(float(m["loss"]))


def test_train_state_port_to_jax(tmp_path):
    """The port's train state after two steps restores into the JAX
    package bit for bit."""
    cfg = get_smoke_config(ARCH)
    tp, to = make_train_state(cfg, 0, device="cpu")
    ocfg = OptimizerConfig(warmup_steps=1, total_steps=10,
                           compression="int8_ef")
    data = DataIterator(cfg, SHAPE, device="cpu")
    for _ in range(2):
        tp, to, _ = train_step(tp, to, next(data), cfg, ocfg)
    ckpt.save(str(tmp_path), 2, {"params": tp, "opt": to},
              extra={"data": data.state()})
    _, jp, jo = jax_state(key=9)
    tree, step, extra = jckpt.restore(str(tmp_path),
                                      {"params": jp, "opt": jo})
    assert step == 2 and extra["data"] == {"step": 2}
    assert int(tree["opt"].step) == 2
    for t, j in ((tp, tree["params"]), (to.m, tree["opt"].m),
                 (to.v, tree["opt"].v), (to.ef, tree["opt"].ef)):
        for a, b in zip(jax.tree.leaves(params_to_numpy(t)),
                        jax.tree.leaves(j), strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_bf16_model_in_both_directions(tmp_path):
    """A bfloat16 model (the serving dtype): the port's parameters
    restore into the JAX package and back, bit for bit."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              dtype="bfloat16")
    model = TM.init_params(cfg, 0, device="cpu")
    ckpt.save(str(tmp_path / "a"), 1, {"params": model})
    jcfg = dataclasses.replace(jget("llama3-8b"), dtype="bfloat16")
    jlike = {"params": JM.init_params(jcfg, jax.random.PRNGKey(1))}
    jtree, _, _ = jckpt.restore(str(tmp_path / "a"), jlike)
    for a, b in zip(jax.tree.leaves(params_to_numpy(model)),
                    jax.tree.leaves(jtree["params"]), strict=True):
        assert b.dtype == jnp.bfloat16
        np.testing.assert_array_equal(a, _f32(b))
    jckpt.save(str(tmp_path / "b"), 1, jtree)
    back, _, _ = ckpt.restore(str(tmp_path / "b"), {"params": TM.init_params(
        cfg, 5, device="cpu")}, device="cpu")
    for a, b in zip(model.parameters(), back["params"].parameters(),
                    strict=True):
        assert b.dtype == torch.bfloat16 and not b.requires_grad
        assert torch.equal(a, b)


def test_full_train_crash_resume_cycle(tmp_path):
    """Train 3 steps -> checkpoint -> 'crash' -> resume -> the state of
    an uninterrupted 6-step run, bit for bit (the data stream too)."""
    cfg = get_smoke_config(ARCH)
    ocfg = OptimizerConfig(warmup_steps=1, total_steps=20)

    def run(n_steps, params, opt, data):
        for _ in range(n_steps):
            params, opt, _ = train_step(params, opt, next(data), cfg, ocfg)
        return params, opt

    p_ref, o_ref = run(6, *make_train_state(cfg, 0, device="cpu"),
                       DataIterator(cfg, SHAPE, device="cpu"))
    p1, o1 = make_train_state(cfg, 0, device="cpu")
    data1 = DataIterator(cfg, SHAPE, device="cpu")
    p1, o1 = run(3, p1, o1, data1)
    ckpt.save(str(tmp_path), 3, {"params": p1, "opt": o1},
              extra={"data": data1.state()})
    del p1, o1, data1                                   # "crash"

    like = dict(zip(("params", "opt"), make_train_state(cfg, 9,
                                                        device="cpu")))
    restored, step, extra = ckpt.restore(str(tmp_path), like, device="cpu")
    data2 = DataIterator(cfg, SHAPE, device="cpu")
    data2.restore(extra["data"])
    assert step == 3 and data2.step == 3
    p2, o2 = run(3, restored["params"], restored["opt"], data2)
    for a, b in zip(p_ref.parameters(), p2.parameters(), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(o_ref.v.parameters(), o2.v.parameters(), strict=True):
        assert torch.equal(a, b)
    assert int(o2.step) == 6


# --------------------------------------------------- fault policies ---- #
def test_assign_shards_deterministic_and_complete():
    a = assign_shards(10, [3, 1, 2])
    assert a == assign_shards(10, [2, 3, 1])
    assert a == jfault.assign_shards(10, [3, 1, 2])
    assert sorted(s for v in a.values() for s in v) == list(range(10))
    with pytest.raises(ValueError):
        assign_shards(3, [])


def test_reassign_on_failure_covers_all():
    a = reassign_on_failure(16, list(range(4)), failed=[1])
    assert a == jfault.reassign_on_failure(16, list(range(4)), failed=[1])
    assert 1 not in a
    assert sorted(s for v in a.values() for s in v) == list(range(16))
    sizes = [len(v) for v in a.values()]
    assert max(sizes) - min(sizes) <= 1


@given(n=st.integers(1, 64), hosts=st.sets(st.integers(0, 31), min_size=1,
                                           max_size=16))
@settings(max_examples=30, deadline=None)
def test_assign_shards_property(n, hosts):
    a = assign_shards(n, sorted(hosts))
    assert a == jfault.assign_shards(n, sorted(hosts))
    assert sorted(s for v in a.values() for s in v) == list(range(n))
    sizes = [len(v) for v in a.values()]
    assert max(sizes) - min(sizes) <= 1


def test_straggler_detection_and_backup():
    pol, jpol = StragglerPolicy(threshold=2.0), jfault.StragglerPolicy(2.0)
    times = {0: [1.0] * 8, 1: [1.1] * 8, 2: [5.0] * 8, 3: [0.9] * 8}
    stragglers = pol.detect(times)
    assert stragglers == [2] == jpol.detect(times)
    assert pol.detect({0: [1.0]}) == []
    assignment = assign_shards(8, [0, 1, 2, 3])
    backups = pol.backups(stragglers, assignment)
    assert backups == jpol.backups(stragglers, assignment)
    assert sorted(s for v in backups.values() for s in v) == assignment[2]
    assert 2 not in backups
    assert pol.backups([0, 1, 2, 3], assignment) == {}


def test_preemption_guard():
    g = PreemptionGuard(install=False)
    assert not g.should_stop
    g.flag()
    assert g.should_stop


def test_run_with_restarts():
    for impl in (run_with_restarts, jfault.run_with_restarts):
        calls = {"n": 0}
        failures = []

        def step_fn(step):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("injected failure")
            return step + 1

        final = impl(step_fn, 0, 3, max_restarts=2,
                     on_failure=lambda s, e: failures.append((s, str(e))))
        assert final == 3 and calls["n"] == 4
        assert failures == [(1, "injected failure")]


def test_run_with_restarts_exhausted():
    def always_fail(step):
        raise RuntimeError("down")
    with pytest.raises(RuntimeError):
        run_with_restarts(always_fail, 0, 2, max_restarts=1)


# ------------------------------------------------------------- data ---- #
def test_data_pipeline_deterministic_and_elastic():
    """One host and four hosts give the same global batch, which is the
    JAX package's (within one process: see the module's hash quirk)."""
    cfg = get_config(ARCH)
    shape = ShapeConfig("t", seq_len=8, global_batch=8, kind="train")
    full = make_batch(cfg, shape, step=5, device="cpu")
    parts = [make_batch(cfg, shape, step=5, host_id=h, n_hosts=4,
                        device="cpu") for h in range(4)]
    merged = torch.cat([p["tokens"] for p in parts])
    assert torch.equal(full["tokens"], merged)
    assert full["tokens"].dtype == torch.int32
    jfull = jpipe.make_batch(jget_config(ARCH), JShape("t", 8, 8, "train"),
                             step=5)
    np.testing.assert_array_equal(full["tokens"].numpy(),
                                  np.asarray(jfull["tokens"]))
    with pytest.raises(ValueError):
        make_batch(cfg, shape, step=0, n_hosts=3, device="cpu")


def test_data_iterator_checkpoint_roundtrip():
    cfg = get_config(ARCH)
    shape = ShapeConfig("t", seq_len=8, global_batch=2, kind="train")
    it = DataIterator(cfg, shape, device="cpu")
    next(it)
    next(it)
    state = it.state()
    b3 = next(it)
    it2 = DataIterator(cfg, shape, device="cpu")
    it2.restore(state)
    assert torch.equal(b3["tokens"], next(it2)["tokens"])
    jit = jpipe.DataIterator(jget_config(ARCH), JShape("t", 8, 2, "train"))
    jit.restore(state)
    np.testing.assert_array_equal(b3["tokens"].numpy(),
                                  np.asarray(next(jit)["tokens"]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_matches_jax_per_family(arch):
    """Every input of a smoke train batch (tokens, frame embeddings and
    labels, vision embeddings) equal to the JAX package's."""
    t = make_batch(get_smoke_config(arch), SHAPE, step=2, device="cpu")
    j = jpipe.make_batch(jget(arch), JShape("t", 16, 4, "train"), step=2)
    assert set(t) == set(j)
    for k in j:
        assert t[k].dtype == (torch.int32 if j[k].dtype == jnp.int32
                              else torch.float32)
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_cover_all_cells(arch):
    """Every applicable (arch x shape) cell has well-formed input specs,
    meta tensors of the JAX specs' shapes and dtypes."""
    cfg = get_config(arch)
    assert applicable_shapes(cfg)
    for shape_name in applicable_shapes(cfg):
        shape = SHAPES[shape_name]
        specs = input_specs(cfg, shape_name)
        jspecs = jpipe.input_specs(jget_config(arch), shape_name)
        assert set(specs) == set(jspecs) and specs, (arch, shape_name)
        for name, s in specs.items():
            assert s.device.type == "meta"
            assert tuple(s.shape) == jspecs[name].shape
            assert str(s.dtype).removeprefix("torch.") == str(
                jspecs[name].dtype)
            assert s.shape[0] == shape.global_batch
            if shape.is_decode and name in ("tokens", "embeds"):
                assert s.shape[1] == 1
        if cfg.family == "vlm" and not shape.is_decode:
            assert "vision_embeds" in specs
        if cfg.family == "audio":
            assert "embeds" in specs and "tokens" not in specs
    assert batch_shapes(cfg, SHAPES["train_4k"])
