"""The port's LM configs and parameter trees against the JAX package: the
ten architectures field by field, the derived sizes, the shape registry,
the tree's shapes and logical axes, and the init distribution (the
reference's stacked fan-in quirk included)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.models import model as TM

from lm_parity import one_torch_thread  # noqa: F401

ARCHS = jconfigs.ARCH_IDS


def test_arch_ids_match():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_and_derived_sizes_match_jax(arch, which):
    get = {"full": "get_config", "smoke": "get_smoke_config"}[which]
    j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for name in ("param_count", "active_param_count"):
        assert getattr(t, name)() == getattr(j, name)(), name
    for name in ("padded_vocab", "d_inner", "ssm_heads", "attends",
                 "sub_quadratic"):
        assert getattr(t, name) == getattr(j, name), name
    assert tbase.applicable_shapes(t) == jbase.applicable_shapes(j)


def test_shape_registry_matches_jax():
    assert ({k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} ==
            {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()})
    assert [s.is_decode for s in tbase.SHAPES.values()] == \
        [s.is_decode for s in jbase.SHAPES.values()]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_param_tree_shapes_and_axes_match_jax(arch, which):
    """The full widths too: the port's abstract tree is meta tensors, so
    llama3-8b's 8 billion parameters cost nothing here."""
    get = {"full": "get_config", "smoke": "get_smoke_config"}[which]
    jc, tc = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    jshapes = dict(_flat(jax.tree.map(lambda s: tuple(s.shape),
                                      JM.abstract_params(jc))))
    tabs = dict(_flat(TM.abstract_params(tc)))
    assert {k: tuple(v.shape) for k, v in tabs.items()} == jshapes
    assert all(v.device.type == "meta" for v in tabs.values())
    jaxes = JM.param_logical_axes(jc)
    jflat = dict(_flat(jax.tree.map(lambda a: a, jaxes,
                                    is_leaf=lambda x: isinstance(x, tuple))))
    assert dict(_flat(TM.param_logical_axes(tc))) == jflat
    assert TM.cache_logical_axes(tc) == JM.cache_logical_axes(jc)
    if (arch, which) == ("llama3-8b", "full"):
        # param_count() leaves out the final norm's d_model scales
        assert tc.param_count() == 8_030_257_152
        assert sum(v.numel() for v in tabs.values()) == 8_030_257_152 + 4096


def _port_leaves(model, tree):
    """The port's parameters stacked back into the JAX layout."""
    out = {}
    for path, _ in _flat(tree):
        leaves = [model]
        for key in path:
            nxt = []
            for m in leaves:
                sub = m[key]
                nxt.extend(sub if isinstance(sub, torch.nn.ModuleList)
                           else [sub])
            leaves = nxt
            # a ModuleList of ModuleLists (vlm / hybrid groups)
            while leaves and isinstance(leaves[0], torch.nn.ModuleList):
                leaves = [x for m in leaves for x in m]
        out[path] = torch.stack([t.detach().float() for t in leaves])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_distribution(arch):
    """Each leaf of at least 4096 elements has the std of the JAX init
    within 5 %, and that std is scale / sqrt(stacked fan-in)."""
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jp = jax.jit(lambda k: JM.init_params(jc, k))(jax.random.PRNGKey(0))
    tp = TM.init_params(tc, 0, device="cpu")
    jtree = jax.tree.map(np.asarray, jp)
    jflat = dict(_flat(jtree))
    tflat = _port_leaves(tp, jtree)
    checked = 0
    for path, ja in jflat.items():
        ta = tflat[path].reshape(ja.shape).numpy()
        assert ta.dtype == ja.dtype
        if ja.size < 4096 or np.std(ja) == 0:
            # zeros / ones leaves: the same constant
            if np.std(ja) == 0:
                assert np.array_equal(ta, ja), path
            continue
        fan_in = ja.shape[0]
        assert np.std(ja) == pytest.approx(1 / np.sqrt(fan_in) * (
            0.5 if path[-1].startswith("conv_") else 1.0), rel=0.05), path
        assert np.std(ta) == pytest.approx(np.std(ja), rel=0.05), path
        checked += 1
    assert checked >= 3


def test_llama3_smoke_layer_std_is_the_stacked_quirk():
    """The reference draws per-layer weights with std 1/sqrt(n_layers)
    (the stacked leaf's first dim), the head with 1/sqrt(d_model)."""
    tc = tconfigs.get_smoke_config("llama3-8b")
    tp = TM.init_params(tc, 0, device="cpu")
    wq = torch.stack([layer["attn"]["wq"] for layer in tp["layers"]])
    gate = torch.stack([layer["mlp"]["wi_gate"] for layer in tp["layers"]])
    assert float(wq.std()) == pytest.approx(1 / np.sqrt(2), rel=0.05)
    assert float(gate.std()) == pytest.approx(1 / np.sqrt(2), rel=0.05)
    assert float(tp["head"]["kernel"].std()) == pytest.approx(
        1 / np.sqrt(64), rel=0.05)


def test_init_params_is_seeded_and_defaults_to_the_card(monkeypatch):
    tc = tconfigs.get_smoke_config("mamba2-2.7b")
    a = TM.init_params(tc, 3, device="cpu")
    b = TM.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    assert not torch.equal(TM.init_params(tc, 4, device="cpu")["head"][
        "kernel"], a["head"]["kernel"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_params(tc, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_cache(tc, 1, 8)
