"""The port's multi-pod dry run against the JAX dry run, part 3: the
per-device argument bytes.  For every smoke cell on the 16 x 16 and the
2 x 16 x 16 mesh the port's ``argument_bytes`` equal the sum, over the
leaves of the JAX ``build_cell``'s specs, of the shard size in bytes;
that sum equals ``memory_analysis().argument_size_in_bytes`` of two
compiled cells; and every full-width cell's sum, from the leaf shapes
alone, equals the port's.  The JAX side runs in one process
(``tests/dryrun_jax.py``)."""
import pytest
import torch

from repro_torch.configs import (ARCH_IDS, applicable_shapes, get_config,
                                 get_smoke_config)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.train.tree import leaves as tree_leaves

from dryrun_parity import jax_result, start_jax

SMOKE = [(a, s) for a in ARCH_IDS
         for s in applicable_shapes(get_smoke_config(a))]
FULL = [(a, s) for a in ARCH_IDS for s in applicable_shapes(get_config(a))]
MESHES = ("pod", "multipod")
COMPILED = [("llama3-8b", "decode_32k"), ("olmoe-1b-7b", "train_4k")]


@pytest.fixture(scope="module")
def jax_bytes():
    procs = {"smoke": start_jax("args", SMOKE),
             "memory": start_jax("memory", COMPILED),
             "full": start_jax("full-args")}
    return {k: jax_result(p) for k, p in procs.items()}


@pytest.fixture(scope="module")
def meshes():
    return {kind: make_production_mesh(
        multi_pod=kind == "multipod",
        devices=["meta"] * (512 if kind == "multipod" else 256))
        for kind in MESHES}


def _argument_bytes(cfg, shape, mesh) -> tuple[int, int]:
    """(per-device, global) bytes of a cell's arguments, from its specs;
    the meta arguments themselves hold the global bytes."""
    _, args, specs = dryrun.build_cell(cfg, shape, mesh)
    leaves = dryrun.spec_leaves(list(specs))
    held = sum(t.numel() * t.element_size()
               for t in tree_leaves(list(args)))
    assert held == sum(s.nbytes for s in leaves)
    return sum(s.shard_nbytes for s in leaves), held


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch,shape", SMOKE)
def test_smoke_argument_bytes_equal_jax_shard_sums(jax_bytes, meshes, arch,
                                                   shape, mesh_kind):
    got, _ = _argument_bytes(get_smoke_config(arch), shape,
                             meshes[mesh_kind])
    assert got == jax_bytes["smoke"][f"{arch}:{shape}:{mesh_kind}"]


@pytest.mark.parametrize("arch,shape", COMPILED)
def test_shard_sum_is_jax_compiled_argument_size(jax_bytes, meshes, arch,
                                                 shape):
    mem = jax_bytes["memory"][f"{arch}:{shape}"]
    assert mem["argument_size_in_bytes"] == mem["shard_bytes"]
    got, _ = _argument_bytes(get_smoke_config(arch), shape, meshes["pod"])
    assert got == mem["argument_size_in_bytes"]


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch,shape", FULL)
def test_full_width_argument_bytes_equal_jax_shard_sums(jax_bytes, meshes,
                                                        arch, shape,
                                                        mesh_kind):
    got, held = _argument_bytes(get_config(arch), shape, meshes[mesh_kind])
    assert got == jax_bytes["full"][f"{arch}:{shape}:{mesh_kind}"]
    assert got * meshes[mesh_kind].size >= held


def test_arguments_are_meta_and_trainable_only_for_training(meshes):
    """The training view is the float32 master copy with gradients, the
    serving view ``cfg.dtype`` without; nothing is allocated."""
    mesh = meshes["pod"]
    cfg = get_config("llama3-8b")
    (_, (params, opt, _), _) = dryrun.build_cell(cfg, "train_4k", mesh)
    leaves = list(params.parameters())
    assert all(p.is_meta and p.dtype == torch.float32 and p.requires_grad
               for p in leaves)
    assert opt.ef == {} and opt.step.is_meta
    assert sum(p.numel() for p in leaves) == sum(
        t.numel() for t in tree_leaves(M.abstract_params(cfg)))
    (_, (params, _, cache), _) = dryrun.build_cell(cfg, "decode_32k", mesh)
    assert all(p.is_meta and p.dtype == torch.bfloat16
               and not p.requires_grad for p in params.parameters())
    assert all(t.is_meta for t in cache.values())
