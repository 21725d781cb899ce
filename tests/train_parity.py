"""Shared by the gradient parity tests: one smoke config's loss and
gradients through the JAX package and the port, on the same weights (the
JAX ``make_train_state``'s, carried by ``repro_torch.models.convert``) and
the same batch, then one ``train_step`` each.

The batch is ``train_batch.batch``, from a fixed numpy seed (why: its
docstring); ``make_batch``'s streams themselves are held equal to the JAX
package's in ``test_torch_checkpoint.py``.

Tolerances, from the largest differences measured on the ten smoke
configs (CPU, float32, this batch): the loss within rtol 1e-5 (measured
9.4e-7); each gradient leaf within 1e-3 of that leaf's largest JAX
gradient (measured 1.9e-4 at worst, llama3-8b's ``layers/attn/wk``); the
step's gradient norm within rtol 1e-4 (measured 4.3e-5)."""
import jax
import numpy as np
import torch

from repro.configs import get_smoke_config as jget
from repro.train import OptimizerConfig as JOpt
from repro.train import make_train_state as jmake_state
from repro.train import train_step as jtrain_step
from repro.train.train_step import loss_fn as jloss_fn
from repro_torch.configs import get_smoke_config as tget
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.layers import map_tree
from repro_torch.train import (OptimizerConfig, init_opt_state, loss_fn,
                               train_step)
from train_batch import batch

LOSS_RTOL = 1e-5
GRAD_SHARE = 1e-3
NORM_RTOL = 1e-4
OPT = dict(warmup_steps=2, total_steps=10)


def run_pair(arch: str) -> dict:
    jcfg, tcfg = jget(arch), tget(arch)
    jp, jo = jmake_state(jcfg, jax.random.PRNGKey(0), "none")
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu",
                           trainable=True)
    data = batch(tcfg)
    jb = {k: jax.numpy.asarray(v) for k, v in data.items()}
    tb = {k: torch.from_numpy(v) for k, v in data.items()}

    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, b, jcfg), has_aux=True))(jp, jb)
    total, tm = loss_fn(tp, tb, tcfg)
    total.backward()
    tg = params_to_numpy(map_tree(tp, lambda path, p: p.grad))
    res = {"jax": {"total": float(jl), "aux": float(jm["aux_loss"]),
                   "grads": jax.tree.map(np.asarray, jg)},
           "port": {"total": float(total.detach()),
                    "aux": float(tm["aux_loss"].detach()), "grads": tg}}

    _, _, jsm = jax.jit(lambda p, o, b: jtrain_step(
        p, o, b, jcfg, JOpt(**OPT)))(jp, jo, jb)
    _, _, tsm = train_step(tp, init_opt_state(tp), tb, tcfg,
                           OptimizerConfig(**OPT))
    for side, m in (("jax", jsm), ("port", tsm)):
        res[side]["step"] = {k: float(v) for k, v in m.items()}
    return res


def check_pair(res: dict) -> None:
    j, t = res["jax"], res["port"]
    np.testing.assert_allclose(t["total"], j["total"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(t["aux"], j["aux"], rtol=LOSS_RTOL,
                               atol=1e-8)
    flat_j = jax.tree_util.tree_flatten_with_path(j["grads"])[0]
    flat_t = jax.tree_util.tree_flatten_with_path(t["grads"])[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert a.shape == b.shape and np.all(np.isfinite(b)), path
        scale = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_SHARE * scale,
                                   err_msg=jax.tree_util.keystr(path))
    js, ts = j["step"], t["step"]
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(ts["grad_norm"], js["grad_norm"],
                               rtol=NORM_RTOL)
    np.testing.assert_allclose(ts["lr"], js["lr"], rtol=1e-6)
    assert ts["dropped_frac"] == js["dropped_frac"]


