"""The port's training path on the mesh against the JAX package's: the loss
and every gradient of olmoe's smoke config under a 2 x 4 mesh against
``jax.value_and_grad`` under the same mesh (``tests/train_parity.py``'s
batch and tolerances); remat's recompute keeping the forward's mesh when
the backward runs on another thread (as autograd runs it on the card);
the train launcher over a host mesh of 8 CPU positions against the JAX
launcher on conftest's 8 devices (the same loss lines; a batch that does
not split over the data axis raises in both); and the mesh path
importing no JAX."""
import dataclasses
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.launch import train as jlaunch
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.sharding import partition as JP
from repro.train import make_train_state as jmake_state
from repro_torch.configs import get_smoke_config as tget
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.sharding import partition as TP
from repro_torch.train import loss_fn, make_train_state

from lm_parity import one_torch_thread  # noqa: F401
from test_torch_train_launch import (EARLY_LOSS, EARLY_STEPS, SAME_LOSS,
                                     _lines, _run)
from train_batch import batch as fixed_batch
from train_parity import check_pair, run_pair

ARCH = "olmoe-1b-7b"
ARGV = ["--arch", ARCH, "--smoke", "--batch", "8", "--seq", "16",
        "--steps", "3", "--log-every", "1"]


def test_train_step_matches_jax_under_the_mesh():
    """Loss, aux loss, every gradient leaf and one train step's metrics;
    the batch drops tokens at each data shard's capacity."""
    with JP.use_mesh(jmake_mesh((2, 4), ("data", "model"))), \
            TP.use_mesh(make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)):
        res = run_pair(ARCH)
    check_pair(res)
    assert res["port"]["step"]["dropped_frac"] > 0


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_recompute_in_another_thread_keeps_the_mesh(policy):
    """On the card autograd runs the backward pass, and so a remat block's
    recompute, on a thread of its own, where the thread-local mesh is
    unset: the recompute re-enters the forward's mesh.  A backward run in
    another thread gives the gradients of "none" remat, bit for bit."""
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    grads = {}
    for name in ("none", policy):
        cfg = dataclasses.replace(tget(ARCH), remat_policy=name)
        model, _ = make_train_state(cfg, 0, device="cpu")
        data = {k: torch.from_numpy(v) for k, v in fixed_batch(cfg).items()}
        with TP.use_mesh(mesh):
            total, _ = loss_fn(model, data, cfg)
        errors = []

        def backward():
            try:
                total.backward()
            except Exception as e:      # re-raised below, in the test
                errors.append(e)
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive()
        if errors:
            raise errors[0]
        grads[name] = [p.grad for p in model.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(grads["none"],
                                                 grads[policy], strict=True))


def test_launcher_on_the_host_mesh_prints_the_jax_launchers_losses():
    """The JAX launcher runs on make_host_mesh() of conftest's 8 devices,
    so its MoE layers take moe_ep (each data shard's capacity and aux
    loss); the port's, given the same 8 positions, does the same and
    prints the same losses.  The printed gradient norms are not compared:
    olmoe's float32 gradients are sensitive to make_batch's per-process
    stream (over 25 streams the norms parted by up to 1.6e-4 at step 1
    and 2.6e-2 at step 3, relative; the printed losses not at all at step
    1 and by at most 5e-4 at steps 2-3); the gradients are held on a
    fixed batch in test_train_step_matches_jax_under_the_mesh."""
    assert jax.device_count() == 8
    _, jout = _run(jlaunch, ARGV)
    jp, _ = jmake_state(jget(ARCH), jax.random.PRNGKey(0))
    model = params_from_numpy(tget(ARCH), jax.tree.map(np.asarray, jp),
                              device="cpu", trainable=True)
    _, tout = _run(tlaunch, ARGV, model=model, devices=["cpu"] * 8)
    jl, tl = _lines(jout), _lines(tout)
    assert sorted(jl) == sorted(tl) == [1, 2, 3]
    assert abs(tl[1][0] - jl[1][0]) <= SAME_LOSS, (jl[1], tl[1])
    for s in jl:
        assert tl[s][2] == jl[s][2]                 # the schedule
        if s <= EARLY_STEPS:
            assert abs(tl[s][0] - jl[s][0]) <= EARLY_LOSS, (s, jl[s], tl[s])


def test_launcher_rejects_a_batch_that_does_not_split():
    argv = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq", "16",
            "--steps", "1"]
    with pytest.raises(ValueError):
        _run(jlaunch, argv)
    with pytest.raises(ValueError, match="does not split"):
        _run(tlaunch, argv, devices=["cpu"] * 8)
    # one position is no mesh: any batch
    res, _ = _run(tlaunch, argv, devices=["cpu"])
    assert np.isfinite(res["final_loss"])


def test_mesh_path_imports_no_jax():
    """The launcher on a host mesh and restore into shardings, in a
    process of their own: neither JAX, the JAX package nor ml_dtypes is
    imported."""
    code = (
        "import sys, tempfile\n"
        "from repro_torch.launch import train\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.launch.mesh import make_mesh\n"
        "from repro_torch.models import model as M\n"
        "from repro_torch.sharding import partition as P_\n"
        "from repro_torch.train import checkpoint as ckpt, make_train_state\n"
        "d = tempfile.mkdtemp()\n"
        "train.run(['--arch', 'olmoe-1b-7b', '--smoke', '--batch', '2',\n"
        "           '--seq', '8', '--steps', '1', '--ckpt-dir', d],\n"
        "          devices=['cpu'] * 2)\n"
        "cfg = get_smoke_config('olmoe-1b-7b')\n"
        "mesh = make_mesh((2, 1), ('data', 'model'), ['cpu'] * 2)\n"
        "sh = P_.param_shardings(M.param_logical_axes(cfg), mesh)\n"
        "like = dict(zip(('params', 'opt'), make_train_state(cfg, 1,\n"
        "                                                    device='cpu')))\n"
        "ckpt.restore(d, like, shardings={'params': sh, 'opt': None})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'repro', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout
