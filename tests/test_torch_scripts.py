"""The card scripts on the CPU: ``chip_smoke.py`` and
``scripts/k2_tile_sweep.py`` refuse to run without a card (non-zero exit,
no result line), ``chip_smoke.py`` refuses to run outside the repository,
reads the registers and spills of every instantiation of the streaming
matvec kernel (K2) from an ``nvcc -Xptxas -v`` log, and bounds K2's and
K3's operations by the cheapest float32-accurate split product on the
tensor cores."""
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


def _log(entries):
    """An ``nvcc -Xptxas -v`` log of K2 instantiations: (storage type,
    queries per CTA, registers, spill stores, spill loads)."""
    lines = []
    for p, qp, regs, st, ld in entries:
        fn = ("_ZN52_GLOBAL__N__c1987883_19_streaming_matvec_cu_6cda7f82"
              f"23streaming_matvec_kernelI{MANGLED[p]}Li{qp}ENS_3CfgILi2ELi2"
              "ELi2ELi3ELi1ELi0EEEEEvPKT_PKfPfiii")
        lines += [f"ptxas info    : Compiling entry function '{fn}' for "
                  "'sm_90a'",
                  f"ptxas info    : Function properties for {fn}",
                  f"    0 bytes stack frame, {st} bytes spill stores, {ld} "
                  "bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers"]
    return "\n".join(lines)


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
