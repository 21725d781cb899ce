"""What the benchmark may import, and how it fails where it cannot run."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parent
ROOT = PB.parent
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}


def imported_names(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports, whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def modules():
    return sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(
    p.relative_to(PB)))
def test_no_jax_and_no_jax_package(path):
    top = {n.split(".")[0] for n in imported_names(path)}
    assert not top & BANNED, f"{path.name} imports {sorted(top & BANNED)}"


def test_repro_torch_is_not_repro():
    # the port's name begins with the JAX package's: compare whole names
    assert "repro_torch".split(".")[0] not in BANNED


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in imported_names(path):
        assert name.split(".")[0] != "repro_torch", name
        if name.startswith("perfbench"):
            assert name.startswith("perfbench.reference"), name


def _run(cwd: Path, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "graph500_22.solve",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120)


def test_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "src/repro_torch" in out.stderr


def test_fails_without_a_card():
    # a CPU-only torch: no result line, a nonzero exit
    out = _run(ROOT)
    assert out.returncode == 3 and out.stdout == ""


def test_a_run_loads_no_jax():
    code = (
        "import sys, time\n"
        "sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "from pathlib import Path\n"
        "from perfbench import bench as B\n"
        "b = B.Benchmark(Path(sys.argv[1]), parked=True)\n"
        "out = B.run_cell(b, 'protein5k.serve', 3, 0.2, False, device='cpu',"
        " t_start=time.perf_counter(), config_overrides={'n': 200},"
        " traffic_overrides={'rate_per_s': 20})\n"
        "print(out['forbidden'], out['result']['attempted'])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[0] == "[]"
