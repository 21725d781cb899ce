"""Shared pieces of the dry-run parity tests (``tests/test_torch_dryrun*.py``):
the JAX side in a process of its own (``tests/dryrun_jax.py``), the
port's dot FLOPs of a cell on a 1 x 1 mesh of meta positions, and the
known differences between the two counts, each with its size."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.configs import SHAPES
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parents[1]
JAX_SCRIPT = ROOT / "tests" / "dryrun_jax.py"
FLOPS_RTOL = 1e-6

# JAX's dot_stats weights a computation by its while nesting only, so the
# dots XLA fused into computations that a layer-scan body calls count
# once, not once per layer.  Only these two cells have such dots (their
# decode scans keep the projections in fusions); the port counts every
# product it runs.  The FLOPs dot_stats misses there:
JAX_UNWEIGHTED = {"mamba2-2.7b:long_500k": 31_872,
                  "zamba2-2.7b:long_500k": 118_656}


def port_minus_jax(cfg: ModelConfig, shape_name: str) -> int:
    """The dot FLOPs the port's program counts beyond the JAX program's
    (ROADMAP, the quirks of slice 13):

    * ssm / hybrid training: JAX's transpose of the two three-operand SSD
      einsums writes the decay factor's gradient, a sum over the head
      dimension, as a dot_general (2 x B x S x heads x headdim FLOPs, two
      per Mamba2 layer); the port's autograd writes it as a multiply and
      a sum, which are no products;
    * vlm prefill: the port projects each cross block's vision K and V
      twice (for the cache and in ``cross_attention``), XLA once (CSE):
      two products of 2 x B x T_v x D x (K x hd) per group."""
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    g, per = M.n_groups(cfg)
    if cfg.family in ("ssm", "hybrid") and shape.kind == "train":
        return -2 * g * per * (2 * B * S * cfg.ssm_heads * cfg.ssm_headdim)
    if cfg.family == "vlm" and shape.kind == "prefill":
        return g * 2 * (2 * B * cfg.n_vision_tokens * cfg.d_model
                        * cfg.n_kv_heads * cfg.head_dim)
    return 0


def start_jax(mode: str, cells=None) -> subprocess.Popen:
    """``tests/dryrun_jax.py`` in a process of its own (its JAX sets 512
    host devices); read the result with :func:`jax_result`."""
    cmd = [sys.executable, str(JAX_SCRIPT), mode]
    if cells is not None:
        cmd.append(",".join(f"{a}:{s}" for a, s in cells))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def jax_result(proc: subprocess.Popen, timeout: float = 300) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def beside_jax(mode: str, cells, work):
    """``work()`` while the JAX side of ``mode`` runs; returns (JAX's
    result, ``work()``'s)."""
    proc = start_jax(mode, cells)
    try:
        mine = work()
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    return jax_result(proc), mine


def port_dot_flops(cfg: ModelConfig, shape_name: str) -> int:
    """The port's dot FLOPs of one cell on a 1 x 1 mesh of meta
    positions."""
    mesh = make_mesh((1, 1), ("data", "model"), ["meta"])
    fn, args, specs = dryrun.build_cell(cfg, shape_name, mesh)
    rules = dryrun.cell_rules(mesh, SHAPES[shape_name].kind)
    return dryrun.measure(fn, args, specs, mesh, rules).counter.dot_flops
