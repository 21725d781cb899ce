"""Shared by the LM model parity tests: one smoke config run through the
JAX package and the port on the same weights (JAX ``init_params``,
carried by ``repro_torch.models.convert``) and the same numpy inputs —
``forward``, ``prefill`` and three ``decode_step``s."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.models import model as JM
from repro_torch.configs import get_smoke_config as tget
from repro_torch.models import model as TM
from repro_torch.models.convert import (cache_from_numpy, cache_to_numpy,
                                        params_from_numpy)

B, S, MAX_LEN, N_DECODE = 2, 8, 16, 3


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _inputs(cfg, rng, length):
    out = {}
    if cfg.embed_input:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, length),
                                     dtype=np.int32)
    else:
        out["embeds"] = rng.standard_normal(
            (B, length, cfg.d_model)).astype(np.float32)
    return out


def run_pair(arch: str, dtype: str | None = None) -> dict:
    jcfg, tcfg = jget(arch), tget(arch)
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    # jitted: one compile instead of one per leaf
    jp = jax.jit(lambda k: JM.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")

    rng = np.random.default_rng(0)
    batch = _inputs(jcfg, rng, S)
    if jcfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, jcfg.n_vision_tokens, jcfg.vision_dim)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    res = {"cfg": tcfg, "jax": {}, "port": {}}
    jl, ja = jax.jit(lambda p, b: JM.forward(p, b, jcfg))(jp, jb)
    tl, ta = TM.forward(tp, tb, tcfg)
    res["jax"]["forward"] = (_f32(jl), {k: float(v) for k, v in ja.items()})
    res["port"]["forward"] = (tl.numpy(), {k: float(v) for k, v in ta.items()})

    jl, jc = jax.jit(lambda p, b: JM.prefill(p, b, jcfg, MAX_LEN))(jp, jb)
    tl, tc = TM.prefill(tp, tb, tcfg, MAX_LEN)
    res["jax"]["prefill"] = (_f32(jl), {k: _f32(v) for k, v in jc.items()})
    res["port"]["prefill"] = (tl.numpy(), cache_to_numpy(tc))

    step = jax.jit(lambda p, b, c: JM.decode_step(p, b, c, jcfg))
    for i in range(N_DECODE):
        d = _inputs(jcfg, rng, 1)
        jl, jc = step(jp, {k: jnp.asarray(v) for k, v in d.items()}, jc)
        tl, tc = TM.decode_step(tp, {k: torch.from_numpy(v)
                                     for k, v in d.items()}, tc, tcfg)
        res["jax"][f"decode{i}"] = (_f32(jl),
                                    {k: _f32(v) for k, v in jc.items()})
        res["port"][f"decode{i}"] = (tl.numpy(), cache_to_numpy(tc))
    # the JAX cache carried into the port decodes to the same step
    carried = cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    d = _inputs(jcfg, rng, 1)
    res["jax"]["carried"] = _f32(step(
        jp, {k: jnp.asarray(v) for k, v in d.items()}, jc)[0])
    res["port"]["carried"] = TM.decode_step(
        tp, {k: torch.from_numpy(v) for k, v in d.items()}, carried,
        tcfg)[0].float().numpy()
    return res


# float32 tolerances, from the largest differences measured on the ten
# smoke configs (CPU, both packages float32): logits exceed rtol 1e-5 by
# at most 3.6e-5 (atol 1e-4); K / V caches by 8.1e-5 (atol 2e-4); the
# SSM and conv states, summed in another order by the chunked scan and
# of magnitude ~1e2, exceed rtol 1e-4 by at most 1.35e-4 (atol 1e-3)
F32 = {"logits": dict(rtol=1e-5, atol=1e-4),
       "kv": dict(rtol=1e-5, atol=2e-4),
       "state": dict(rtol=1e-4, atol=1e-3)}
# bf16 (the llama3-8b smoke config in bfloat16): both packages round the
# activations to bf16 at slightly different places; measured largest
# differences 0.052 on logits of magnitude 4 and 0.125 (two bf16 steps)
# on K / V of magnitude 18
BF16 = {"logits": dict(rtol=0, atol=0.1), "kv": dict(rtol=0, atol=0.25),
        "state": None}
_KIND = {"k": "kv", "v": "kv", "cross_k": "kv", "cross_v": "kv",
         "ssm": "state", "conv": "state"}


def check_stage(res: dict, stage: str, tol: dict) -> None:
    (pl, pc), (jl, jc) = res["port"][stage], res["jax"][stage]
    assert pl.shape == jl.shape
    assert np.all(np.isfinite(pl))
    np.testing.assert_allclose(pl, jl, **tol["logits"])
    if stage == "forward":
        np.testing.assert_allclose(pc["aux_loss"], jc["aux_loss"],
                                   rtol=1e-5, atol=1e-7)
        assert pc["dropped_frac"] == jc["dropped_frac"]
        return
    assert set(pc) == set(jc)
    assert int(pc["len"]) == int(jc["len"])
    for name in sorted(set(jc) - {"len"}):
        assert pc[name].shape == jc[name].shape, name
        np.testing.assert_allclose(pc[name], jc[name], err_msg=name,
                                   **tol[_KIND[name]])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The smoke models are tiny: one intra-op thread per test process
    keeps six test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
