"""The port's multi-pod dry run against the JAX dry run, part 2: the global
dot FLOPs of the SSM families' smoke cells (mamba2, zamba2) on a 1 x 1
mesh, within rtol 1e-6 of JAX's ``dot_stats`` plus the known differences
(``dryrun_parity``), with JAX's own count reweighted through the call
graph to show what its trip weighting misses; and ``moe_ep``'s
collectives counted on a 2 x 4 mesh of meta positions against the same
steps run on a 2 x 4 mesh of the CPU."""
import pytest
import torch

from repro_torch.configs import (ARCH_IDS, ShapeConfig, applicable_shapes,
                                 get_smoke_config)
from repro_torch.core import fabric_matvec as fm
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.sharding import partition as P_
from repro_torch.train import OptimizerConfig, make_train_state, train_step

from dryrun_parity import (FLOPS_RTOL, JAX_UNWEIGHTED, beside_jax,
                           port_dot_flops, port_minus_jax)
from lm_parity import one_torch_thread  # noqa: F401

ARCHS = [a for a in ARCH_IDS
         if get_smoke_config(a).family in ("ssm", "hybrid")]
CELLS = [(a, s) for a in ARCHS
         for s in applicable_shapes(get_smoke_config(a))]


@pytest.fixture(scope="module")
def flops():
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


@pytest.mark.parametrize("arch,shape", CELLS)
def test_jax_trip_weighting_misses_fused_dots(flops, arch, shape):
    """JAX's count reweighted through the call graph differs from
    ``dot_stats`` by exactly the recorded amount (none outside the two
    long-context decode cells)."""
    jax_side, _ = flops
    key = f"{arch}:{shape}"
    got = jax_side[key]["weighted"] - jax_side[key]["dot_flops"]
    assert got == JAX_UNWEIGHTED.get(key, 0)


# (d): small shapes, so the CPU runs them; the batch splits over the 2-way
# data axis
MOE_ARCHS = ("olmoe-1b-7b", "granite-moe-3b-a800m")
MOE_SHAPES = {"train": ShapeConfig("t", 8, 4, "train"),
              "decode": ShapeConfig("d", 16, 4, "decode")}


def _cpu_collectives(cfg, shape, mesh) -> dict:
    """One step of ``shape`` on real CPU tensors under ``mesh``: the
    collectives as the dry run reports them."""
    rules = dryrun.cell_rules(mesh, shape.kind)
    batch = make_batch(cfg, shape, 0, device="cpu")
    if shape.kind == "train":
        params, opt = make_train_state(cfg, 0, compression="none",
                                       device="cpu")

        def step():
            train_step(params, opt, batch, cfg, OptimizerConfig())
    else:
        params = M.init_params(cfg, 0, device="cpu")
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device="cpu")
        batch = {"tokens": batch["tokens"][:, :1]}

        def step():
            with torch.no_grad():
                M.decode_step(params, batch, cache, cfg)
    fm.reset_counts()
    with P_.use_mesh(mesh, rules):
        step()
    return dryrun.collective_stats()


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("kind", sorted(MOE_SHAPES))
def test_moe_ep_collectives_meta_equal_cpu(arch, kind):
    cfg, shape = get_smoke_config(arch), MOE_SHAPES[kind]
    meta = make_mesh((2, 4), ("data", "model"), ["meta"] * 8)
    fn, args, specs = dryrun.build_cell(cfg, shape, meta)
    got = dryrun.measure(fn, args, specs, meta,
                         dryrun.cell_rules(meta, kind)).collectives
    cpu = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    want = _cpu_collectives(cfg, shape, cpu)
    assert got == want
    # a psum over model and two over data a layer; training all-gathers
    # the 4 expert weights a layer (FSDP) and its remat gathers again
    assert got["all-reduce"]["count"] % (3 * cfg.n_layers) == 0
    assert ("all-gather" in got) == (kind == "train")
