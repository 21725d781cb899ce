"""The port's training launcher against the JAX package's: on the JAX
launcher's own weights it prints the same loss lines, a fault drill
(``--fail-at`` then ``--resume``) ends bit-equal to an uninterrupted run,
and a JAX launcher's checkpoint resumes in the port's.  The launcher as a
module and the example run in ``test_torch_train_example.py``."""
import contextlib
import io
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.launch import train as jlaunch
from repro.train import make_train_state as jmake_state
from repro_torch.configs import get_smoke_config as tget
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import make_train_state

from lm_parity import one_torch_thread  # noqa: F401

ARCH = "internlm2-1.8b"
LINE = re.compile(r"^step (\d+): loss=([\d.]+) gnorm=([\d.]+) lr=([\d.e+-]+)")
# the lines print the loss to 4 decimals and the norm to 3.  A step from
# the same weights and batch gives the same loss to ~1e-7 (one printed
# digit) and a gradient norm within 7.8e-5 of its value (over 25 of
# make_batch's per-process streams: float32 sums in another order); later
# steps part by Adam's sign (test_torch_train.py) and the gap compounds:
# over the same streams steps 2-3 differed by at most 3e-4 in the loss,
# steps 4-6 by 1e-3, so losses are compared up to step 3 and the schedule
# at every step
SAME_LOSS, SAME_GNORM_RTOL, PRINTED_GNORM = 1.5e-4, 2e-4, 1e-3
EARLY_LOSS, EARLY_STEPS = 1e-3, 3


def _same_step(t, j):
    """One step's (loss, gnorm, lr) from the same weights and batch."""
    return (abs(t[0] - j[0]) <= SAME_LOSS and
            abs(t[1] - j[1]) <= SAME_GNORM_RTOL * j[1] + PRINTED_GNORM)


def _lines(text):
    out = {}
    for line in text.splitlines():
        m = LINE.match(line)
        if m:
            out[int(m.group(1))] = tuple(float(g) for g in m.groups()[1:])
    return out


def _run(launcher, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = launcher.run(argv, **kw)
    return res, buf.getvalue()


def test_launcher_prints_the_jax_launchers_losses():
    arch = ARCH
    argv = ["--arch", arch, "--smoke", "--steps", "6", "--log-every", "1"]
    jres, jout = _run(jlaunch, argv)
    jp, _ = jmake_state(jget(arch), jax.random.PRNGKey(0))
    model = params_from_numpy(tget(arch), jax.tree.map(np.asarray, jp),
                              device="cpu", trainable=True)
    tres, tout = _run(tlaunch, argv + ["--device", "cpu"], model=model)
    jl, tl = _lines(jout), _lines(tout)
    assert sorted(jl) == sorted(tl) == list(range(1, 7))
    assert _same_step(tl[1], jl[1]), (jl[1], tl[1])
    for s in jl:
        assert tl[s][2] == jl[s][2]                 # the schedule
        if s <= EARLY_STEPS:
            assert abs(tl[s][0] - jl[s][0]) <= EARLY_LOSS, (s, jl[s], tl[s])
    assert round(tres["final_loss"], 4) == tl[6][0]
    assert np.isfinite(jres["final_loss"])
    # the launcher trained the model it was given, in place
    assert not torch.equal(next(model.parameters()),
                           torch.tensor(np.asarray(jp["embed"]["table"])))


def test_launcher_fault_drill_is_bit_equal(tmp_path):
    """--fail-at 3 raises the launcher's own error after checkpointing;
    --resume finishes the run; its final checkpoint is the uninterrupted
    run's, bit for bit."""
    base = ["--arch", ARCH, "--smoke", "--steps", "6", "--ckpt-every", "3",
            "--device", "cpu"]
    drill, ref = str(tmp_path / "drill"), str(tmp_path / "ref")
    with pytest.raises(RuntimeError, match="^injected failure at step 3$"):
        _run(tlaunch, base + ["--ckpt-dir", drill, "--fail-at", "3"])
    assert ckpt.list_steps(drill) == [3]
    res, out = _run(tlaunch, base + ["--ckpt-dir", drill, "--resume"])
    assert "resumed from step 3" in out
    ref_res, _ = _run(tlaunch, base + ["--ckpt-dir", ref])
    assert res == ref_res
    like = dict(zip(("params", "opt"), make_train_state(tget(ARCH), 1,
                                                        device="cpu")))
    a, sa, ea = ckpt.restore(drill, like, device="cpu")
    b, sb, eb = ckpt.restore(ref, like, device="cpu")
    assert sa == sb == 6 and ea == eb == {"data": {"step": 6}, "arch": ARCH}
    for x, y in zip(params_to_numpy(a["params"]).values(),
                    params_to_numpy(b["params"]).values()):
        for u, v in zip(jax.tree.leaves(x), jax.tree.leaves(y)):
            np.testing.assert_array_equal(u, v)
    assert int(a["opt"].step) == 6


def test_port_launcher_resumes_a_jax_checkpoint(tmp_path):
    """The JAX launcher's drill checkpoint (step 3) resumes in the port's
    launcher, whose step-4 line is the JAX run's."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "5", "--log-every", "1",
            "--ckpt-every", "3"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        _run(jlaunch, argv + ["--ckpt-dir", jdir, "--fail-at", "3"])
    shutil.copytree(jdir, tdir)
    _, jout = _run(jlaunch, argv + ["--ckpt-dir", jdir, "--resume"])
    _, tout = _run(tlaunch, argv + ["--ckpt-dir", tdir, "--resume",
                                    "--device", "cpu", "--steps", "4"])
    assert "resumed from step 3" in tout
    jl, tl = _lines(jout), _lines(tout)
    assert list(tl) == [4]
    assert _same_step(tl[4], jl[4]), (jl[4], tl[4])


def test_launcher_rejects_a_model_it_cannot_train():
    cfg = tget(ARCH)
    for model in (TM.init_params(cfg, 0, device="cpu"),        # frozen
                  TM.init_params(tget("llama3-8b"), 0, device="cpu",
                                 trainable=True)):
        with pytest.raises(ValueError):
            tlaunch.run(["--arch", ARCH, "--smoke", "--device", "cpu"],
                        model=model)
