"""The port's training launcher as a module and its example, each in its
own process on the CPU: ``examples/torch_train_lm.py`` does what
``examples/train_lm.py`` does (the same model size, schedule, checkpoint
halfway and final loss bound)."""
import os
import re
import subprocess
import sys
from pathlib import Path

from repro_torch.train import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"


def _subprocess(*args, timeout=300):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT, env=env)


def test_launcher_module_runs_on_cpu():
    out = _subprocess("-m", "repro_torch.launch.train", "--arch", ARCH,
                      "--smoke", "--steps", "5", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert re.findall(r"^step (\d+): loss=", out.stdout, re.M) == ["5"]


def test_example_does_what_the_jax_example_does(tmp_path):
    """The same model size, the same schedule and loop (a checkpoint and
    a restore halfway), and both end below ln(V) - 1; the port's draws
    are its own, so its losses are its own."""
    jout = _subprocess("examples/train_lm.py", "--ckpt-dir",
                       str(tmp_path / "jax"))
    tout = _subprocess("examples/torch_train_lm.py", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "port"))
    assert jout.returncode == 0, jout.stderr
    assert tout.returncode == 0, tout.stderr
    for out in (jout.stdout, tout.stdout):
        assert out.rstrip().endswith("train_lm: OK")
        assert "model: 5.2M params | 80 steps | batch 2 x seq 64" in out
        assert "== checkpoint @ 40; simulating crash+resume ==" in out
    lr = re.compile(r"step +(\d+) +loss=[\d.]+ +lr=([\d.e+-]+)")
    assert lr.findall(jout.stdout) == lr.findall(tout.stdout)
    assert ckpt.list_steps(str(tmp_path / "port")) == [40]
