"""The port's LM models under a mesh against the JAX package under the same
mesh shape: ``forward``, ``prefill`` and three ``decode_step``s of olmoe
(the expert-parallel MoE), granite-moe (5 experts padded to 8, and K = 2
kv heads on a 4-way model axis: the JAX attention's repeat path) and
internlm2 (dense: only GSPMD's layout constraints, which change no value)
on a 2 x 4 mesh under the default rules, and olmoe on the serving mesh
(1 x 4, inference rules).  The port's mesh is ``["cpu"] * n``; the JAX one
conftest's virtual CPU devices.

Tolerances: ``lm_parity``'s float32 ones, and for olmoe on 1 x 4 the
wider ``SERVE_MESH`` on the logits: there each of the four positions
runs a block of two experts, and both packages' GEMMs on those blocks
round apart by more than the unsharded ones.  Measured (one thread, CPU):
the logits exceed rtol 1e-5 by at most 1.0e-4 on 1 x 4 (the second
decode step; 5.9e-5 on 2 x 4, 3.5e-5 without a mesh); the K / V caches
by 1.5e-4 (6.7e-5 without a mesh), within ``F32``'s 2e-4."""
import numpy as np
import pytest

from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import attention as jattn
from repro.sharding import partition as JP
from repro_torch.core import fabric_matvec as fm
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import partition as TP

from lm_parity import (F32, N_DECODE, check_stage,  # noqa: F401
                       one_torch_thread, run_pair)

SERVE_MESH = dict(F32, logits=dict(rtol=1e-5, atol=2.5e-4))
CASES = [("olmoe-1b-7b", (2, 4), "DEFAULT_RULES", F32),
         ("granite-moe-3b-a800m", (2, 4), "DEFAULT_RULES", F32),
         ("internlm2-1.8b", (2, 4), "DEFAULT_RULES", F32),
         ("olmoe-1b-7b", (1, 4), "INFERENCE_RULES", SERVE_MESH)]
STAGES = ["forward", "prefill"] + [f"decode{i}" for i in range(N_DECODE)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{s[0]}x{s[1]}" for a, s, _, _ in CASES])
def pair(request):
    arch, shape, rules, tol = request.param
    mesh = make_mesh(shape, ("data", "model"), ["cpu"] * (shape[0]
                                                         * shape[1]))
    fm.reset_counts()
    with JP.use_mesh(jmake_mesh(shape, ("data", "model")),
                     getattr(JP, rules)), \
            TP.use_mesh(mesh, getattr(TP, rules)):
        res = run_pair(arch)
        kv_repeat = not jattn._kv_heads_shardable(res["cfg"].n_kv_heads)
    return res, tol, dict(fm.collectives), kv_repeat


@pytest.mark.parametrize("stage", STAGES)
def test_matches_jax_under_the_mesh(pair, stage):
    res, tol, _, _ = pair
    check_stage(res, stage, tol)


def test_carried_jax_cache_decodes_the_same(pair):
    res, tol, _, _ = pair
    np.testing.assert_allclose(res["port"]["carried"], res["jax"]["carried"],
                               **tol["logits"])


def test_the_mesh_took_the_expected_paths(pair):
    """The MoE configs ran the expert-parallel path (its psums counted:
    3 a layer a call); the JAX attention took the repeat path wherever
    the kv heads do not split over the model axis (granite-moe's 2,
    internlm2's), and the port's grouped arithmetic was held to it; the
    dense config issued no collective."""
    res, _, collectives, kv_repeat = pair
    cfg = res["cfg"]
    if cfg.family == "moe":
        # forward, prefill, 3 decode steps and the carried one
        calls = cfg.n_layers * (3 + N_DECODE)
        assert collectives["psum"] == 3 * calls
    else:
        assert collectives == {}
    assert kv_repeat == (cfg.n_kv_heads % 4 != 0)
    if cfg.name == "granite-moe-3b-a800m-smoke":
        assert kv_repeat
