"""The port's logical-axis sharding rules (``repro_torch.sharding``) against
the JAX package's: every rule case of ``tests/test_sharding_data.py``
through both, ``fitted_pspec`` for every leaf of the ten full configs on
a 16 x 16 and a 2 x 16 x 16 mesh, the thread-local active mesh,
``moe_ep_applicable``, the shardings of a tree, and ``checkpoint.restore``
into shardings."""
import threading

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import moe_ep as jep
from repro.sharding import partition as JP
from repro_torch import configs as tconfigs
from repro_torch.core.fabric_matvec import P
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as TM
from repro_torch.models import moe_ep as tep
from repro_torch.sharding import partition as TP
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import make_train_state

from lm_parity import one_torch_thread  # noqa: F401

RULE_TABLES = ["DEFAULT_RULES", "MULTIPOD_RULES", "INFERENCE_RULES",
               "INFERENCE_MULTIPOD_RULES"]


class _FakeMesh:
    """The JAX side's stand-in for a production mesh (the test process has
    8 devices), as ``tests/test_sharding_data.py`` builds it."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _cpu_mesh(shape: dict):
    """The port's mesh of that shape, every position on the CPU."""
    n = 1
    for s in shape.values():
        n *= s
    return make_mesh(tuple(shape.values()), tuple(shape), ["cpu"] * n)


@pytest.mark.parametrize("table", RULE_TABLES)
def test_rule_tables_are_the_jax_ones(table):
    assert getattr(TP, table) == getattr(JP, table)


@pytest.mark.parametrize("axes,table,want", [
    (("embed", "mlp"), "DEFAULT_RULES", ("data", "model")),
    (("vocab", "embed"), "DEFAULT_RULES", ("model", "data")),
    ((None, None), "DEFAULT_RULES", (None, None)),
    # both map to 'model': the second use drops to None
    (("mlp", "vocab"), "DEFAULT_RULES", ("model", None)),
    (("batch", None), "MULTIPOD_RULES", (("pod", "data"), None)),
    (("embed", "mlp"), "INFERENCE_RULES", (None, "model")),
    (("embed", "batch", "experts"), "INFERENCE_MULTIPOD_RULES",
     (None, ("pod", "data"), "model")),
])
def test_logical_to_pspec_matches_jax(axes, table, want):
    """The cases of tests/test_sharding_data.py:17-40, through both."""
    got = TP.logical_to_pspec(axes, getattr(TP, table))
    assert isinstance(got, P)
    assert tuple(got) == want
    assert tuple(got) == tuple(JP.logical_to_pspec(axes, getattr(JP,
                                                                 table)))


@pytest.mark.parametrize("shape,axes,want", [
    # kv_heads = 8 on a 16-way model axis falls back to replication
    ((2048, 8, 128), ("embed", "kv_heads", None), ("data", None, None)),
    ((2048, 32, 128), ("embed", "heads", None), ("data", "model", None)),
    ((49155,), ("vocab",), (None,)),
])
def test_fitted_pspec_drops_nondivisible(monkeypatch, shape, axes, want):
    """tests/test_sharding_data.py:43-60 through both packages."""
    mesh = {"data": 16, "model": 16}
    monkeypatch.setattr(JP, "current_mesh", lambda: _FakeMesh(mesh))
    with TP.use_mesh(_cpu_mesh(mesh)):
        got = TP.fitted_pspec(shape, axes, TP.DEFAULT_RULES)
    assert tuple(got) == want
    assert tuple(got) == tuple(JP.fitted_pspec(shape, axes,
                                               JP.DEFAULT_RULES))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("mesh", [{"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16}],
                         ids=["16x16", "2x16x16"])
def test_fitted_pspec_of_every_full_leaf_matches_jax(monkeypatch, arch,
                                                     mesh):
    """Every parameter of the full config, at its stacked shape (meta
    tensors), under the rules a launcher picks for the mesh, and under
    the inference rules."""
    monkeypatch.setattr(JP, "current_mesh", lambda: _FakeMesh(mesh))
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jshapes = dict(_leaves(jax.tree.map(lambda a: tuple(a.shape),
                                        JM.abstract_params(jcfg))))
    jaxes = dict(_leaves(JM.param_logical_axes(jcfg)))
    tshapes = dict(_leaves(TM.abstract_params(tcfg)))
    taxes = dict(_leaves(TM.param_logical_axes(tcfg)))
    assert sorted(tshapes) == sorted(jshapes) == sorted(taxes)
    multipod = "pod" in mesh
    # the launchers' pick for the mesh (None), and the inference rules
    inference = ("INFERENCE_MULTIPOD_RULES" if multipod
                 else "INFERENCE_RULES")
    for rules in (None, inference):
        jrules = (getattr(JP, rules) if rules else
                  JP.MULTIPOD_RULES if multipod else JP.DEFAULT_RULES)
        with TP.use_mesh(_cpu_mesh(mesh),
                         getattr(TP, rules) if rules else None):
            fitted = TP.fitted_shardings(TM.abstract_params(tcfg),
                                         TM.param_logical_axes(tcfg),
                                         TP.current_mesh())
            for path, t in tshapes.items():
                assert tuple(t.shape) == jshapes[path], path
                assert taxes[path] == tuple(jaxes[path]), path
                got = TP.fitted_pspec(tuple(t.shape), taxes[path])
                want = JP.fitted_pspec(jshapes[path], tuple(jaxes[path]),
                                       jrules)
                assert tuple(got) == tuple(want), (path, got, want)
                node = fitted
                for k in path:
                    node = node[k]
                assert tuple(node.spec) == tuple(want), path
                node.check(t.shape)


def test_use_mesh_nests_restores_and_is_per_thread():
    assert TP.current_mesh() is None
    assert TP.current_rules() is TP.DEFAULT_RULES
    outer = _cpu_mesh({"data": 2, "model": 4})
    pod = _cpu_mesh({"pod": 2, "data": 2, "model": 2})
    seen = []
    with TP.use_mesh(outer):
        assert TP.current_mesh() is outer
        assert TP.current_rules() is TP.DEFAULT_RULES
        with TP.use_mesh(pod):
            # a mesh with a pod axis picks the multi-pod rules
            assert TP.current_mesh() is pod
            assert TP.current_rules() is TP.MULTIPOD_RULES
            with TP.use_mesh(outer, TP.INFERENCE_RULES):
                assert TP.current_rules() is TP.INFERENCE_RULES
            assert TP.current_rules() is TP.MULTIPOD_RULES
        assert TP.current_mesh() is outer
        t = threading.Thread(target=lambda: seen.append(TP.current_mesh()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with pytest.raises(RuntimeError):
            with TP.use_mesh(None):
                assert TP.current_mesh() is None
                raise RuntimeError
        assert TP.current_mesh() is outer
    assert seen == [None]
    assert TP.current_mesh() is None
    assert TP.current_rules() is TP.DEFAULT_RULES


def test_shard_returns_its_argument_under_a_mesh():
    x = torch.arange(8.0).reshape(2, 4)
    with TP.use_mesh(_cpu_mesh({"data": 2, "model": 4})):
        assert TP.shard(x, ("batch", "act_embed")) is x
    assert TP.shard(x, ("batch", "act_embed")) is x


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (4, 1), (8, 1), (1, 1),
                                   (2, 2, 2)])
@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "INFERENCE_RULES"])
def test_moe_ep_applicable_matches_jax(shape, rules):
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                             "model")
    cfg_t = tconfigs.get_smoke_config("olmoe-1b-7b")
    cfg_j = jconfigs.get_smoke_config("olmoe-1b-7b")
    tmesh = _cpu_mesh(dict(zip(axes, shape)))
    jmesh = _FakeMesh(dict(zip(axes, shape)))
    with TP.use_mesh(tmesh, getattr(TP, rules)):
        got = tep.moe_ep_applicable(cfg_t)
    prev = JP.current_mesh(), JP.current_rules()
    JP.set_mesh(jmesh, getattr(JP, rules))
    try:
        want = jep.moe_ep_applicable(cfg_j)
    finally:
        JP.set_mesh(*prev)
    assert got == want
    assert got == (shape != (1, 1))
    assert not tep.moe_ep_applicable(cfg_t)         # no mesh
    for n in (1, 2, 4, 16):
        assert (tep.padded_experts(cfg_t, n)
                == jep.padded_experts(cfg_j, n))
    granite = tconfigs.get_config("granite-moe-3b-a800m")
    assert tep.padded_experts(granite, 16) == 48


def test_param_shardings_of_a_tree():
    cfg = tconfigs.get_smoke_config("olmoe-1b-7b")
    logical = TM.param_logical_axes(cfg)
    none = TP.param_shardings(logical)
    assert all(s is None for _, s in _leaves(none))
    mesh = _cpu_mesh({"data": 2, "model": 4})
    with TP.use_mesh(mesh):
        sh = TP.param_shardings(logical)
    wi = sh["layers"]["moe"]["wi_gate"]
    assert isinstance(wi, TP.NamedSharding) and wi.mesh is mesh
    # (stack, experts, embed, mlp): mlp's "model" is taken by experts
    assert tuple(wi.spec) == (None, "model", "data", None)
    assert wi.device == torch.device("cpu")
    # an explicit mesh and rules, no active mesh
    sh = TP.param_shardings(logical, mesh, TP.INFERENCE_RULES)
    assert tuple(sh["embed"]["table"].spec) == ("model", None)


def _state(cfg, seed):
    return dict(zip(("params", "opt"), make_train_state(cfg, seed,
                                                        device="cpu")))


def test_restore_into_shardings(tmp_path):
    """A checkpoint restored into the shardings of a 2 x 4 mesh: every
    leaf bit-equal, on the mesh's home device, each checked against its
    spec; a spec that does not split raises, as jax.device_put does."""
    cfg = tconfigs.get_smoke_config("olmoe-1b-7b")
    saved = _state(cfg, 0)
    ckpt.save(str(tmp_path), 3, saved, extra={"arch": cfg.name})
    like = _state(cfg, 1)
    mesh = _cpu_mesh({"data": 2, "model": 4})
    with TP.use_mesh(mesh):
        params = TP.param_shardings(TM.param_logical_axes(cfg))
    replicated = TP.NamedSharding(mesh, P())
    opt = type(like["opt"])(step=replicated, m=params, v=params,
                            ef=params)
    shardings = {"params": params, "opt": opt}
    got, step, extra = ckpt.restore(str(tmp_path), like,
                                    shardings=shardings)
    assert step == 3 and extra == {"arch": cfg.name}
    for a, b in zip(got["params"].parameters(),
                    saved["params"].parameters(), strict=True):
        assert torch.equal(a, b) and a.requires_grad
    for tree in ("m", "v", "ef"):
        for a, b in zip(getattr(got["opt"], tree).parameters(),
                        getattr(saved["opt"], tree).parameters()):
            assert torch.equal(a, b)
    assert int(got["opt"].step) == int(saved["opt"].step)
    # None subtrees: those leaves go where the others go
    part = {"params": params, "opt": None}
    got, _, _ = ckpt.restore(str(tmp_path), like, shardings=part)
    assert got["opt"].step.device == torch.device("cpu")
    with pytest.raises(ValueError, match="not both"):
        ckpt.restore(str(tmp_path), like, device="cpu", shardings=part)
    # d_model = 64 does not split over 3 data shards
    odd = _cpu_mesh({"data": 3, "model": 1})
    with TP.use_mesh(odd):
        bad = TP.param_shardings(TM.param_logical_axes(cfg))
    with pytest.raises(ValueError, match="does not split"):
        ckpt.restore(str(tmp_path), like,
                     shardings={"params": bad, "opt": None})
    # the fitted shardings of the same mesh drop the axis and restore
    with TP.use_mesh(odd):
        fitted = TP.fitted_shardings(TM.abstract_params(cfg),
                                     TM.param_logical_axes(cfg), odd)
    got, _, _ = ckpt.restore(str(tmp_path), like,
                             shardings={"params": fitted, "opt": None})
    assert all(torch.equal(a, b) for a, b in zip(
        got["params"].parameters(), saved["params"].parameters()))
