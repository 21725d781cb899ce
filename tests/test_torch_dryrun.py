"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) against the
JAX dry run (``repro.launch.dryrun``), part 1: the global dot FLOPs of the
smoke cells of the attention families (dense, MoE, audio, vlm) on a 1 x 1
mesh, within rtol 1e-6 of JAX's ``dot_stats`` plus the one known
difference (``dryrun_parity.port_minus_jax``); the parameter counts of
every full config; and the command line in its own process on a
full-width decode cell of the pod mesh.  The JAX side runs in one process
(``tests/dryrun_jax.py``): its dry run sets 512 host devices.  The SSM
families' cells are in ``test_torch_dryrun_ssm.py``, the argument bytes
in ``test_torch_dryrun_shard.py``."""
import json
import os
import subprocess
import sys

import pytest

from repro import configs as jconfigs
from repro_torch.configs import (ARCH_IDS, applicable_shapes, get_config,
                                 get_smoke_config)

from dryrun_parity import (FLOPS_RTOL, JAX_UNWEIGHTED, ROOT, beside_jax,
                           port_dot_flops, port_minus_jax)

ARCHS = [a for a in ARCH_IDS
         if get_smoke_config(a).family not in ("ssm", "hybrid")]
CELLS = [(a, s) for a in ARCHS
         for s in applicable_shapes(get_smoke_config(a))]
RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "status", "lower_s",
               "compile_s", "memory", "cost", "collectives", "dots",
               "param_count", "active_param_count", "n_ops"}


@pytest.fixture(scope="module")
def flops():
    """(JAX, port) dot FLOPs per cell; the port's counted while the JAX
    process compiles."""
    return beside_jax("flops", CELLS, lambda: {
        f"{a}:{s}": port_dot_flops(get_smoke_config(a), s)
        for a, s in CELLS})


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dot_flops_match_jax(flops, arch, shape):
    jax_side, port = flops
    key = f"{arch}:{shape}"
    want = (jax_side[key]["dot_flops"] + JAX_UNWEIGHTED.get(key, 0)
            + port_minus_jax(get_smoke_config(arch), shape))
    assert port[key] == pytest.approx(want, rel=FLOPS_RTOL, abs=0)
    # the JAX count weights every dot of these cells by its trip count
    assert jax_side[key]["weighted"] == jax_side[key]["dot_flops"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_activation_dtype_matches_jax(arch):
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro_torch.models import model as M
    for get in ("get_config", "get_smoke_config"):
        cfg = getattr(jconfigs, get)(arch)
        assert (str(M.activation_dtype(cfg)).removeprefix("torch.")
                == jnp.dtype(JM.activation_dtype(cfg)).name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_jax(arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_cli_writes_the_jax_record(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on a full-width decode cell
    of the pod mesh: exit 0, an OK line and a record with exactly the
    JAX keys (``n_ops`` in place of ``hlo_lines``)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b", "--shape", "decode_32k", "--mesh", "pod",
         "--out", str(tmp_path), "--save-hlo"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-4000:]
    assert "OK   internlm2-1.8b x decode_32k x pod" in out.stdout
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["internlm2-1.8b_decode_32k_pod.json"]
    rec = json.loads((tmp_path / files[0]).read_text())
    assert set(rec) == RECORD_KEYS
    cfg = get_config("internlm2-1.8b")
    assert (rec["n_devices"], rec["status"], rec["compile_s"]) == (256, "ok",
                                                                  0.0)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert rec["cost"] == {"flops": float(rec["dots"]["dot_flops"])}
    assert rec["collectives"] == {}                 # a dense model
    assert rec["param_count"] == cfg.param_count()
    # bf16 weights stationary over 16 model positions: under a device's
    # share of the global bytes, above a 16th of the weights
    weights = 2 * cfg.param_count()
    assert weights / 16 < rec["memory"]["argument_bytes"] < weights
