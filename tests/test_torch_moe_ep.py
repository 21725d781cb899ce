"""The port's expert-parallel MoE (``repro_torch.models.moe_ep``) against the
JAX ``moe_ep`` on the same mesh shape: the port's mesh is ``["cpu"] * n``,
the JAX one conftest's virtual CPU devices.  At the default capacity,
where tokens drop, on 2 x 4, 1 x 4, 4 x 1 and 8 x 1, under the training
and the inference rules, for olmoe's smoke config and granite-moe's (5
experts, padded to 8 on a 4-way model axis): the output, the aux loss,
the dropped fraction and the gradients of every weight and of x.  At
``capacity_factor=8`` (no drops) against ``moe_reference``.

Tolerances, from the largest differences measured over these cases
(float32, CPU): the output within rtol 1e-5 plus 1e-6 of its largest
magnitude (measured 1.2e-7 of it beyond rtol: an output near 0.1 summed
from expert outputs of magnitude ~50 in another order); the aux loss
within rtol 1e-6 (9e-8); each gradient leaf within 1e-5 of its largest
value (5.7e-7); the dropped fraction equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import moe as jmoe
from repro.models import moe_ep as jep
from repro.models.layers import init_tree
from repro.sharding import partition as JP
from repro_torch.configs import get_smoke_config as tget
from repro_torch.core import fabric_matvec as fm
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import moe_ep as tep
from repro_torch.sharding import partition as TP

from lm_parity import one_torch_thread  # noqa: F401

Y_RTOL, Y_ATOL_SHARE = 1e-5, 1e-6
AUX_RTOL = 1e-6
GRAD_SHARE = 1e-5
ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]
MESHES = [(2, 4), (1, 4), (4, 1), (8, 1)]
RULES = ["DEFAULT_RULES", "INFERENCE_RULES"]
B, S = 8, 16


def _case(arch, capacity_factor=None):
    """The JAX test's weights (init_tree from key 0) and x (numpy seed 1)."""
    jcfg, tcfg = jget(arch), tget(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    params = jax.tree.map(np.asarray, init_tree(jmoe.moe_specs(jcfg),
                                                jax.random.PRNGKey(0)))
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, params, x


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), ["cpu"] * (shape[0]
                                                        * shape[1]))


def _port(fn, params, x, tcfg):
    """y, aux, dropped and the gradients of sum(y**2) + aux w.r.t. every
    weight and x."""
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = fn(tp, tx, tcfg)
    ((y ** 2).sum() + aux["aux_loss"]).backward()
    grads = {k: v.grad.numpy() for k, v in tp.items()}
    grads["x"] = tx.grad.numpy()
    return (y.detach().numpy(), float(aux["aux_loss"].detach()),
            float(aux["dropped_frac"]), grads)


def _jax(params, x, jcfg):
    def loss(p, xx):
        y, a = jep.moe_ep(p, xx, jcfg)
        return jnp.sum(y ** 2) + a["aux_loss"], (y, a)
    (_, (y, a)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    grads = dict(jax.tree.map(np.asarray, gp), x=np.asarray(gx))
    return (np.asarray(y), float(a["aux_loss"]), float(a["dropped_frac"]),
            grads)


def _held(got, want):
    y, aux, dropped, grads = got
    wy, waux, wdropped, wgrads = want
    assert y.shape == wy.shape and np.all(np.isfinite(y))
    np.testing.assert_allclose(y, wy, rtol=Y_RTOL,
                               atol=Y_ATOL_SHARE * np.abs(wy).max())
    np.testing.assert_allclose(aux, waux, rtol=AUX_RTOL)
    assert dropped == wdropped
    assert sorted(grads) == sorted(wgrads)
    for k, g in grads.items():
        scale = np.abs(wgrads[k]).max()
        np.testing.assert_allclose(g, wgrads[k], rtol=0,
                                   atol=GRAD_SHARE * scale, err_msg=k)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ep_matches_jax_moe_ep(arch, shape, rules):
    """At the default capacity (1.25): each data shard's capacity rounds
    down, so tokens drop on some meshes; the port drops the same ones."""
    jcfg, tcfg, params, x = _case(arch)
    with JP.use_mesh(jmake_mesh(shape, ("data", "model")),
                     getattr(JP, rules)):
        want = _jax(params, x, jcfg)
    with TP.use_mesh(_mesh(shape), getattr(TP, rules)):
        assert tep.moe_ep_applicable(tcfg)
        got = _port(tmoe.moe, params, x, tcfg)     # moe dispatches to ep
        again = _port(tep.moe_ep, params, x, tcfg)
    _held(got, want)
    # a repeat is bit-identical (the combine adds in a fixed order)
    assert np.array_equal(again[0], got[0]) and again[1:3] == got[1:3]
    if (arch, shape) in (("olmoe-1b-7b", (2, 4)),
                         ("granite-moe-3b-a800m", (8, 1))):
        assert got[2] > 0                        # the drops were exercised


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ep_matches_the_reference_without_drops(arch, shape):
    """At capacity_factor 8 nothing drops: moe_ep computes moe_reference's
    output and gradients; its aux loss is the mean over the data shards
    of moe_reference's aux loss on each shard's tokens."""
    _, tcfg, params, x = _case(arch, capacity_factor=8.0)
    with TP.use_mesh(_mesh(shape), TP.DEFAULT_RULES):
        got = _port(tep.moe_ep, params, x, tcfg)
    want = _port(tmoe.moe_reference, params, x, tcfg)
    y, aux, dropped, grads = got
    assert dropped == want[2] == 0.0
    np.testing.assert_allclose(y, want[0], rtol=Y_RTOL,
                               atol=Y_ATOL_SHARE * np.abs(want[0]).max())
    for k, g in grads.items():
        if k == "router":
            continue    # the aux losses differ, and so their gradients
        np.testing.assert_allclose(g, want[3][k], rtol=0,
                                   atol=GRAD_SHARE * np.abs(want[3][k]).max(),
                                   err_msg=k)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    shards = torch.tensor(x).chunk(shape[0])
    per_shard = [float(tmoe.moe_reference(tp, s, tcfg)[1]["aux_loss"])
                 for s in shards]
    np.testing.assert_allclose(aux, np.mean(per_shard), rtol=AUX_RTOL)


def test_a_batch_that_does_not_split_over_data_raises():
    jcfg, tcfg, params, x = _case("olmoe-1b-7b")
    x = x[:4]                                    # 4 rows on 8 data shards
    with JP.use_mesh(jmake_mesh((8, 1), ("data", "model"))):
        with pytest.raises(ValueError):
            jep.moe_ep(params, jnp.asarray(x), jcfg)
    with TP.use_mesh(_mesh((8, 1))):
        with pytest.raises(ValueError, match="does not split"):
            tmoe.moe({k: torch.tensor(v) for k, v in params.items()},
                     torch.tensor(x), tcfg)


@pytest.mark.parametrize("rules,gathers", [("DEFAULT_RULES", 4),
                                           ("INFERENCE_RULES", 0)])
def test_collectives_and_no_copy_of_the_experts(monkeypatch, rules,
                                                gathers):
    """One call: the FSDP all-gathers under the training rules only, the
    combine's psum over model and the two means over data.  Under the
    inference rules every position's expert block is a view of the
    weight it was cut from: a mesh of one device copies no expert
    weights (and no padding copy when E divides the model axis)."""
    _, tcfg, params, x = _case("olmoe-1b-7b")
    tp = {k: torch.tensor(v) for k, v in params.items()}
    placed = []
    cut = tep.ShardedTensor.from_global

    def spy(t, mesh, spec):
        out = cut(t, mesh, spec)
        placed.append((t, out))
        return out

    monkeypatch.setattr(tep.ShardedTensor, "from_global", spy)
    fm.reset_counts()
    with TP.use_mesh(_mesh((1, 4)), getattr(TP, rules)):
        tmoe.moe(tp, torch.tensor(x), tcfg)
    assert fm.collectives == ({"all_gather": gathers, "psum": 3}
                              if gathers else {"psum": 3})
    assert len(placed) == 5                      # x, router, 3 experts
    if gathers:
        return
    for src, sh in placed[2:]:
        assert any(src is tp[k] for k in ("wi_gate", "wi_up", "wo"))
        base = src.untyped_storage().data_ptr()
        assert all(s.untyped_storage().data_ptr() == base
                   for s in sh.shards)
        assert len({s.data_ptr() for s in sh.shards}) == 4
