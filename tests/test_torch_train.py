"""The port's training substrate against the JAX package's: every case of
``tests/test_train.py`` through both packages on the same numpy inputs
(loss, schedule, clipping, AdamW, int8 compression with error feedback,
accumulation), the optimizer fed the same gradients, and the remat
policies.

Adam at step 1 is scale-free (m / sqrt(v) ~ sign(g)), so a parameter
whose gradient is near zero moves by about lr on reduction-order noise of
1e-9: after the first update the two packages' parameters part by O(lr),
and over 15 steps at lr = 1e-2 their losses part by up to 0.1 (measured
on the internlm2 smoke config).  So the multi-step cases hold the first
step to the JAX one and the rest to the JAX test's own property, and the
optimizer is compared on identical gradients (``adamw_update``).  Where
both packages take one batch, it is ``train_batch``'s fixed one (why:
its docstring)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config as jget
from repro.train import OptimizerConfig as JOpt
from repro.train import cross_entropy as jce
from repro.train import init_opt_state as jinit_opt
from repro.train import lr_schedule as jlr
from repro.train import make_train_state as jmake_state
from repro.train import train_step as jtrain_step
from repro.train.compression import \
    compress_with_error_feedback as jcompress
from repro.train.compression import dequantize_int8 as jdeq
from repro.train.compression import quantize_int8 as jquant
from repro.train.optimizer import adamw_update as jadamw
from repro.train.optimizer import clip_by_global_norm as jclip
from repro.train.train_step import loss_fn as jloss_fn
from repro_torch.configs import get_smoke_config as tget
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.layers import map_tree
from repro_torch.train import (OptimizerConfig, cross_entropy,
                               init_opt_state, loss_fn, lr_schedule,
                               train_step)
from repro_torch.train.compression import (compress_with_error_feedback,
                                           compressed_bytes, dequantize_int8,
                                           quantize_int8)
from repro_torch.train.optimizer import (adamw_update, clip_by_global_norm,
                                         global_norm)

from lm_parity import one_torch_thread  # noqa: F401
from train_batch import batch as fixed_batch

SHAPE = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
# a loss of the same weights and batch: float32 sums in another order
LOSS_RTOL = 1e-5


def _np(x):
    return np.asarray(x)


def pair_state(arch: str, key: int = 0, compression: str = "int8_ef"):
    """The JAX train state and the port's on the same (carried) weights."""
    jcfg, tcfg = jget(arch), tget(arch)
    jp, jo = jmake_state(jcfg, jax.random.PRNGKey(key), compression)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu",
                           trainable=True)
    return (jcfg, jp, jo), (tcfg, tp, init_opt_state(tp, compression))


def grads_numpy(params) -> dict:
    """The JAX-layout tree of a model's ``.grad``."""
    return params_to_numpy(map_tree(params, lambda path, p: p.grad))


# ----------------------------------------------------------------- loss -- #
def test_cross_entropy_perfect_prediction():
    logits = np.full((2, 3, 5), -20.0, np.float32)
    labels = np.array([[1, 2, 3], [0, 4, 2]])
    logits[np.arange(2)[:, None], np.arange(3)[None, :], labels] = 20.0
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels)))
    assert got < 1e-3
    assert got == pytest.approx(float(jce(jnp.asarray(logits),
                                          jnp.asarray(labels))), abs=1e-7)


def test_cross_entropy_uniform_is_log_vocab():
    got = float(cross_entropy(torch.zeros((2, 4, 100)),
                              torch.zeros((2, 4), dtype=torch.int32)))
    assert got == pytest.approx(np.log(100), rel=1e-5)
    assert got == pytest.approx(float(jce(jnp.zeros((2, 4, 100)),
                                          jnp.zeros((2, 4), jnp.int32))),
                                rel=1e-6)


def test_cross_entropy_masked_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (2, 5))
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.from_numpy(mask))
    want = jce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_make_train_state_is_the_rounded_draw():
    """The master copy is init_params' draw rounded to cfg.dtype, held in
    float32 and trainable — leaf by leaf the same values as the serving
    draw, never a fresh float32 draw."""
    cfg = dataclasses.replace(tget("llama3-8b"), dtype="bfloat16")
    from repro_torch.train import make_train_state
    params, opt = make_train_state(cfg, 3, device="cpu")
    served = TM.init_params(cfg, 3, device="cpu")
    for p, q in zip(params.parameters(), served.parameters(), strict=True):
        assert p.dtype == torch.float32 and p.requires_grad
        assert q.dtype == torch.bfloat16 and not q.requires_grad
        assert torch.equal(p, q.float())
    assert int(opt.step) == 0 and opt.step.dtype == torch.int32
    assert len(list(opt.ef.parameters())) == len(list(params.parameters()))
    assert init_opt_state(params, "none").ef == {}


# ------------------------------------------------------ train steps ---- #
def _learns(arch, compression, jax_bound):
    (jcfg, jp, jo), (tcfg, tp, to) = pair_state(arch)
    data = fixed_batch(tcfg, SHAPE)              # fixed batch -> memorise
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    tb = {k: torch.from_numpy(v) for k, v in data.items()}
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=40,
              compression=compression)
    jocfg, tocfg = JOpt(**kw), OptimizerConfig(**kw)
    step = jax.jit(lambda p, o, b: jtrain_step(p, o, b, jcfg, jocfg))
    jl, tl = [], []
    for i in range(15):
        jp, jo, jm = step(jp, jo, jb)
        tp, to, tm = train_step(tp, to, tb, tcfg, tocfg)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        if i == 0:
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=1e-4)
            assert float(tm["lr"]) == pytest.approx(float(jm["lr"]),
                                                    rel=1e-6)
    # the first step's loss is the same weights': then Adam's sign parts
    # the two runs by O(lr) (module docstring)
    assert tl[0] == pytest.approx(jl[0], rel=LOSS_RTOL)
    assert tl[1] == pytest.approx(jl[1], rel=1e-3)
    assert jl[-1] < jl[0] * jax_bound, jl
    assert tl[-1] < tl[0] * jax_bound, tl


def test_loss_decreases_over_steps():
    _learns("internlm2-1.8b", "none", 0.7)


def test_compressed_training_still_learns():
    _learns("internlm2-1.8b", "int8_ef", 0.75)


def test_grad_accumulation_matches_full_batch():
    """Microbatched gradients == full-batch gradients (loss and grads),
    in the port and against the JAX package; the accum path of
    train_step gives the full batch's loss."""
    (jcfg, jp, jo), (tcfg, tp, to) = pair_state("llama3-8b", key=1)
    data = fixed_batch(tcfg, SHAPE)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    total, _ = loss_fn(tp, batch, tcfg)
    total.backward()
    l_full, g_full = float(total.detach()), grads_numpy(tp)
    halves, g_acc = [], None
    for i in range(2):
        for p in tp.parameters():
            p.grad = None
        part = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        total, _ = loss_fn(tp, part, tcfg)
        total.backward()
        halves.append(float(total.detach()))
        g = grads_numpy(tp)
        g_acc = g if g_acc is None else jax.tree.map(
            lambda a, b: (a + b) / 2, g_acc, g)
    assert l_full == pytest.approx(sum(halves) / 2, rel=1e-5)
    for a, b in zip(jax.tree.leaves(g_full), jax.tree.leaves(g_acc)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    (jl, _), jg = jax.value_and_grad(jloss_fn, has_aux=True)(
        jp, jbatch, jcfg)
    assert l_full == pytest.approx(float(jl), rel=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(g_full), jax.tree.leaves(jg)):
        b = _np(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-3 * max(np.abs(b).max(), 1e-30))
    ocfg = OptimizerConfig(warmup_steps=1, total_steps=10)
    _, _, m2 = train_step(tp, to, batch, tcfg, ocfg, accum_steps=2)
    assert float(m2["loss"]) == pytest.approx(l_full, rel=1e-5)
    _, _, jm2 = jtrain_step(jp, jo, jbatch, jcfg,
                            JOpt(warmup_steps=1, total_steps=10),
                            accum_steps=2)
    assert float(m2["loss"]) == pytest.approx(float(jm2["loss"]),
                                              rel=LOSS_RTOL)
    assert float(m2["grad_norm"]) == pytest.approx(float(jm2["grad_norm"]),
                                                   rel=1e-4)
    assert all(p.grad is None for p in tp.parameters())


# ------------------------------------------------------- optimizer ----- #
def test_lr_schedule_shape():
    kw = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100,
              min_lr_ratio=0.1)
    cfg, jcfg = OptimizerConfig(**kw), JOpt(**kw)

    def lr(s):
        return float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
    assert lr(0) == 0.0
    assert lr(10) == pytest.approx(1e-3)
    assert lr(5) == pytest.approx(5e-4)
    assert lr(100) == pytest.approx(1e-4, rel=1e-3)
    vals = [lr(s) for s in range(10, 101, 10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))
    for s in range(0, 111):
        assert lr(s) == pytest.approx(float(jlr(jcfg, jnp.int32(s))),
                                      rel=1e-6, abs=1e-12)


def test_clip_by_global_norm():
    g = {"a": torch.ones(3) * 3.0, "b": torch.ones(4) * 4.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(9 * 3 + 16 * 4))
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)
    jg = {"a": jnp.ones((3,)) * 3.0, "b": jnp.ones((4,)) * 4.0}
    jclipped, jnorm = jclip(jg, 1.0)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(), _np(jclipped[k]),
                                   rtol=1e-6)


def test_adamw_weight_decay_pulls_to_zero():
    kw = dict(learning_rate=1e-2, warmup_steps=0, total_steps=10,
              weight_decay=0.5)
    params = {"w": torch.ones(4)}
    p, state, _ = adamw_update(OptimizerConfig(**kw), params,
                               {"w": torch.zeros(4)}, init_opt_state(params))
    assert float(p["w"][0]) < 1.0
    jp, _, _ = jadamw(JOpt(**kw), {"w": jnp.ones((4,))},
                      {"w": jnp.zeros((4,))},
                      jinit_opt({"w": jnp.ones((4,))}))
    np.testing.assert_allclose(p["w"].numpy(), _np(jp["w"]), rtol=1e-7)
    assert int(state.step) == 1


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_on_identical_gradients(compression, clip):
    """Six AdamW steps fed the same numpy gradients (clipped or not,
    int8-compressed with error feedback or not): parameters, moments,
    residuals and metrics as the JAX package's."""
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 3)}}

    def draw(scale):
        return jax.tree.map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=8,
              grad_clip_norm=clip, compression=compression)
    cfg, jcfg = OptimizerConfig(**kw), JOpt(**kw)
    p0 = draw(1.0)
    # copies: the port updates its parameters in place, and jnp.asarray
    # of a numpy array may share its memory
    tp = jax.tree.map(torch.tensor, p0)
    jp = jax.tree.map(jnp.array, p0)
    ts, js = init_opt_state(tp, compression), jinit_opt(jp, compression)
    for _ in range(6):
        g = draw(3.0)
        # copies: the port's update uses its gradients as scratch
        tp, ts, tm = adamw_update(cfg, tp, jax.tree.map(torch.tensor, g),
                                  ts)
        jp, js, jm = jadamw(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        for k in ("lr", "grad_norm", "param_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5)
    assert int(ts.step) == int(js.step) == 6
    pairs = [(tp, jp), (ts.m, js.m), (ts.v, js.v)]
    if compression != "none":
        pairs.append((ts.ef, js.ef))
    else:
        assert ts.ef == {} and js.ef == {}
    for t, j in pairs:
        for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(j), strict=True):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5,
                                       atol=1e-6)


# ------------------------------------------------------ compression ---- #
@given(scale=st.floats(min_value=1e-3, max_value=1e3))
@settings(max_examples=20, deadline=None)
def test_quantize_roundtrip_error_bounded(scale):
    x = (np.random.default_rng(0).normal(size=128) * scale).astype(
        np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    err = np.abs(dequantize_int8(q, s).numpy() - x)
    assert err.max() <= float(s) / 2 + 1e-6
    jq, js = jquant(jnp.asarray(x))
    # bit for bit: round half to even in both, the same float32 division
    np.testing.assert_array_equal(q.numpy(), _np(jq))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.numpy().tobytes() == np.float32(js).tobytes()
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  _np(jdeq(jq, js)))


def test_quantize_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5])
    q, s = quantize_int8(x)
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 4]
    assert q.tolist() == _np(jquant(jnp.asarray(x.numpy()))[0]).tolist()
    q0, s0 = quantize_int8(torch.zeros(3))
    assert float(s0) == 1.0 and q0.tolist() == [0, 0, 0]


def test_error_feedback_accumulates_unbiased():
    """Sum of compressed grads + final residual == sum of true grads, and
    every step's sent gradient and residual are the JAX package's."""
    rng = np.random.default_rng(1)
    ef = {"w": torch.zeros(64)}
    jef = {"w": jnp.zeros((64,))}
    total_true = np.zeros(64)
    total_sent = np.zeros(64)
    for _ in range(20):
        g = rng.normal(size=64).astype(np.float32)
        sent, ef = compress_with_error_feedback({"w": torch.from_numpy(
            g.copy())}, ef)
        jsent, jef = jcompress({"w": jnp.asarray(g)}, jef)
        np.testing.assert_array_equal(sent["w"].numpy(), _np(jsent["w"]))
        np.testing.assert_allclose(ef["w"].numpy(), _np(jef["w"]),
                                   rtol=0, atol=1e-6)
        total_true += g
        total_sent += sent["w"].numpy()
    np.testing.assert_allclose(total_sent + ef["w"].numpy(), total_true,
                               rtol=1e-4, atol=1e-4)


def test_compressed_bytes():
    tree = {"a": torch.zeros(10), "b": {"c": torch.zeros(3, 4)}}
    assert compressed_bytes(tree) == 10 + 4 + 12 + 4
    model = TM.init_params(tget("llama3-8b"), 0, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert compressed_bytes(model) == n + 4 * len(list(model.parameters()))


# ------------------------------------------------------------ remat ---- #
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b",
                                  "mamba2-2.7b", "zamba2-2.7b",
                                  "llama-3.2-vision-90b", "musicgen-large"])
def test_remat_policies_give_the_same_gradients(arch):
    """"full" and "dots" recompute in the backward pass what "none"
    keeps: the loss and every gradient are the same bits on the CPU."""
    base = tget(arch)
    model = TM.init_params(base, 0, device="cpu", trainable=True)
    batch = make_batch(base, SHAPE, step=0, device="cpu")
    got = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        for p in model.parameters():
            p.grad = None
        total, _ = loss_fn(model, batch, cfg)
        total.backward()
        got[policy] = (float(total.detach()), [p.grad.clone()
                                      for p in model.parameters()])
    for policy in ("full", "dots"):
        assert got[policy][0] == got["none"][0]
        for a, b in zip(got[policy][1], got["none"][1], strict=True):
            assert torch.equal(a, b), policy


def test_remat_recomputes_what_the_policy_says():
    """In the backward pass "none" runs only the gradients' products;
    "full" also reruns every product of the forward; "dots" reruns only
    those with a batch dimension (the attention scores), having kept the
    others' outputs.  Counted as matrix products dispatched during
    ``backward``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    products = (aten.mm.default, aten.addmm.default, aten.bmm.default)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in products
            return func(*args, **(kwargs or {}))

    base = tget("internlm2-1.8b")
    model = TM.init_params(base, 0, device="cpu", trainable=True)
    batch = make_batch(base, SHAPE, step=0, device="cpu")
    counted = {}
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        total, _ = loss_fn(model, batch, cfg)
        with Count() as count:
            total.backward()
        counted[policy] = count.n
    # a layer's forward: 3 projections + wo + 3 MLP products without a
    # batch dimension, 2 attention products with one (one key chunk); the
    # recompute stops once it has what the backward needs, before the
    # block's last product (the MLP's wo)
    layers = base.n_layers
    assert counted["full"] == counted["none"] + 8 * layers, counted
    assert counted["dots"] == counted["none"] + 2 * layers, counted


def test_remat_off_without_autograd():
    """Serving and no_grad calls run the blocks as they are: forward
    under each policy gives the same logits, and no checkpoint wraps a
    call autograd does not record."""
    from repro_torch.models import transformer as tfm
    calls = []
    fn = tfm.remat_wrap(lambda *a: calls.append(a) or a[1], "full")
    x = torch.ones(2)
    with torch.no_grad():
        assert fn(None, x) is x
    assert fn(None, x) is x
    assert len(calls) == 2
    with pytest.raises(ValueError):
        tfm.remat_wrap(lambda: None, "some")
    cfg = tget("zamba2-2.7b")
    model = TM.init_params(cfg, 0, device="cpu")
    batch = make_batch(cfg, SHAPE, step=0, device="cpu")
    logits = {p: TM.forward(model, batch, dataclasses.replace(
        cfg, remat_policy=p))[0] for p in ("none", "full", "dots")}
    assert torch.equal(logits["none"], logits["full"])
    assert torch.equal(logits["none"], logits["dots"])
