"""The card scripts on the CPU: ``chip_smoke.py``,
``scripts/k2_tile_sweep.py``, ``scripts/step_tile_sweep.py``,
``scripts/backend_sweep.py`` and ``scripts/mesh_cards_check.py`` refuse to
run without a card (non-zero exit, no result line), ``chip_smoke.py`` refuses to run outside the repository,
reads the registers and spills of every instantiation of the streaming
matvec kernel (K2) and of the PageRank steps (K1, K4) from an ``nvcc
-Xptxas -v`` log, and bounds K2's and K3's operations by the cheapest
float32-accurate split product on the tensor cores.  The port's examples
run on the CPU and print what the JAX package's examples print."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

MANGLED = {"f32": "f", "bf16": "13__nv_bfloat16", "f16": "6__half",
           "int8": "a"}


def _ptxas(fn, regs, st, ld):
    """The lines ``nvcc -Xptxas -v`` prints for one kernel."""
    return [f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'",
            f"ptxas info    : Function properties for {fn}",
            f"    0 bytes stack frame, {st} bytes spill stores, {ld} bytes "
            "spill loads",
            f"ptxas info    : Used {regs} registers, used 1 barriers"]


def _log(entries):
    """An ``nvcc -Xptxas -v`` log of K2 instantiations: (storage type,
    queries per CTA, registers, spill stores, spill loads)."""
    lines = []
    for p, qp, regs, st, ld in entries:
        fn = ("_ZN52_GLOBAL__N__c1987883_19_streaming_matvec_cu_6cda7f82"
              f"23streaming_matvec_kernelI{MANGLED[p]}Li{qp}ENS_3CfgILi2ELi2"
              "ELi2ELi3ELi1ELi0EEEEEvPKT_PKfPfiii")
        lines += _ptxas(fn, regs, st, ld)
    return "\n".join(lines)


def _step_log(storage):
    """A log of K1 (with row scales) and K4 (peeled path) at Cfg<4, 2>,
    and of the leak reduce, which is neither."""
    ns = "_ZN49_GLOBAL__N__2b3a51c7_16_pagerank_step_cu_9e1f0a41"
    k1 = (f"{ns}17fused_step_kernelI{MANGLED[storage]}NS_3CfgILi4ELi2EEELb1"
          "EEEvPKT_PKfS7_S7_S7_PfS8_if")
    k4 = (f"{ns}11step_kernelI{MANGLED[storage]}NS_3CfgILi4ELi2EEELb0EEEvPKT_"
          "PKfS7_Pfiif")
    reduce_ = f"{ns}18leak_reduce_kernelEPKfiPf"
    return "\n".join(_ptxas(k1, 96, 0, 0) + _ptxas(k4, 40, 8, 4)
                     + _ptxas(reduce_, 12, 0, 0))


@pytest.mark.parametrize("storage", list(MANGLED))
def test_k2_instantiations_from_the_ptxas_log(storage):
    entries = [(storage, 8, 84, 0, 0), (storage, 64, 174, 12, 8)]
    got = chip_smoke.k2_instantiations(_log(entries))
    assert got == {
        (storage, 8): {"registers": 84, "spill_stores": 0,
                       "spill_loads": 0},
        (storage, 64): {"registers": 174, "spill_stores": 12,
                        "spill_loads": 8}}
    # K3's reader takes none of them
    assert chip_smoke.k3_instantiations(_log(entries)) == {}


@pytest.mark.parametrize("storage", list(MANGLED))
def test_step_instantiations_from_the_ptxas_log(storage):
    got = chip_smoke.step_instantiations(_step_log(storage))
    assert got == {
        ("K1", storage, (4, 2), True): {
            "registers": 96, "spill_stores": 0, "spill_loads": 0},
        ("K4", storage, (4, 2), False): {
            "registers": 40, "spill_stores": 8, "spill_loads": 4}}
    # the K2 and K3 readers take none of them
    assert chip_smoke.k2_instantiations(_step_log(storage)) == {}
    assert chip_smoke.k3_instantiations(_step_log(storage)) == {}


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the scripts would run")


def test_chip_smoke_fails_without_a_card(no_card):
    out = _run(["chip_smoke.py"], ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "CUDA is not available" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "repro_torch not found" in out.stderr


def test_k2_tile_sweep_fails_without_a_card(no_card):
    out = _run(["scripts/k2_tile_sweep.py", "--probe"], ROOT)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


def test_step_tile_sweep_fails_without_a_card(no_card):
    out = _run(["scripts/step_tile_sweep.py"], ROOT)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


# (storage type, the cheapest scheme): float32 W takes 3 TF32 products per
# term (6 on bf16 take a little longer); bf16 and int8 W are
# exact in bf16, so X in 3 bf16 parts at twice TF32's rate beats 2 TF32
# products; f16 W is not exact in bf16 and keeps 2 TF32 products
@pytest.mark.parametrize("storage,scheme,products,rate", [
    ("f32", "3 x tf32", 3, chip_smoke.TF32_OPS_PER_S),
    ("bf16", "3 x bf16", 3, chip_smoke.BF16_OPS_PER_S),
    ("f16", "2 x tf32", 2, chip_smoke.TF32_OPS_PER_S),
    ("int8", "3 x bf16", 3, chip_smoke.BF16_OPS_PER_S)])
def test_split_bound_takes_the_cheapest_scheme(storage, scheme, products,
                                                rate):
    terms = 64 * 5120 * 5120
    ms, ops, got = chip_smoke.split_bound(storage, terms)
    assert got == scheme
    assert ops == 2 * products * terms
    assert ms == pytest.approx(ops / rate * 1e3, rel=1e-12)
    # no scheme of the table is cheaper than the one taken
    assert all(ms <= 2 * k * terms / r * 1e3
               for k, _, r in chip_smoke.SPLIT_SCHEMES[storage])


def test_mesh_cards_check_fails_without_a_card(no_card):
    out = _run(["scripts/mesh_cards_check.py"], ROOT)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert '"tiers"' not in out.stdout


def test_backend_sweep_fails_without_a_card(no_card):
    out = _run(["scripts/backend_sweep.py"], ROOT)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "dense_wins_from_density" not in out.stdout


# --------------------------------------------------------------------------- #
# the port's examples on the CPU against the JAX package's                    #
# --------------------------------------------------------------------------- #
def example(args, *, jax_devices=8):
    """One example script's run: PYTHONPATH=src, JAX on ``jax_devices``
    virtual CPU devices; fails the test on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{jax_devices}")
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_distributed_example_matches_jax():
    """The 4 x 4 mesh at N = 1024 held to the dense tier at rtol 2e-4, the
    all-reduces per iteration (the JAX example counts them in the compiled
    HLO, the port's from ``lower_run``) and the served top-1 proteins."""
    import re
    jax_out = example(["examples/distributed_pagerank.py"], jax_devices=16)
    out = example(["examples/torch_distributed_pagerank.py",
                    "--device", "cpu"])
    for text in (jax_out, out):
        assert "distributed == single-device reference: OK" in text

    def grab(pattern, text):
        return re.search(pattern, text).group(1)

    assert grab(r"all-reduce x(\d+)", out) == grab(r"all-reduce x(\d+)",
                                                  jax_out)
    assert "'psum': 1, 'psum_masked': 1" in out
    assert "K2 launches {'f32,B=1': 16}" in out
    assert grab(r"top-1 proteins (\[.*\])", out) == grab(
        r"top-1 proteins (\[.*\])", jax_out)


def test_protein_network_example_matches_jax():
    """The launcher example at N = 300: the same top-10 proteins as the
    JAX example, every tier (the sharded ones on 4 CPU positions) within
    the launcher's own gate of the dense tier."""
    import re
    args = ["--nodes", "300", "--iters", "20"]
    jax_out = example(["examples/pagerank_protein_network.py", *args])
    out = example(["examples/torch_pagerank_protein_network.py", *args,
                    "--device", "cpu", "--shards", "4"])

    def top(text):
        return re.findall(r"\((\d+), ", re.search(r"top-10 proteins: (.*)",
                                                   text).group(1))

    assert top(out) == top(jax_out) and len(top(out)) == 10
    for tier in ("dense_sharded", "ell_sharded"):
        assert f"engine_{tier}" in out and f"engine_{tier}" in jax_out
